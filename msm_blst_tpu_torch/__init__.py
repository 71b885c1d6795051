"""msm_blst_tpu_torch — the PyTorch and CUDA port of msm_blst_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is held
against. It runs the CHES "nh + 0.21q" query (msm.msm_ches_device and its
host-recode variant), BGMW95 and stock Pippenger over G1 and G2 end to end,
with the CIOS or the SOS multiply (mul_impl), and the JAX package's
measurement drivers (drivers/); every Pallas kernel of the JAX package is a
CUDA C++ kernel for sm_90a under csrc/, built at first use (kernels.py).
Every kernel module keeps a plain PyTorch version, which CPU tensors take.

The package imports torch and never jax.
"""

__version__ = "0.1.0"

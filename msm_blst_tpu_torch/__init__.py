"""msm_blst_tpu_torch — the PyTorch and CUDA port of msm_blst_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference it is held
against. This slice runs the G1 CHES "nh + 0.21q" query end to end
(msm.msm_ches_device); its four Pallas kernels are CUDA C++ kernels for
sm_90a under csrc/, built at first use (kernels.py). Every kernel module
keeps a plain PyTorch version, which CPU tensors take.

The package imports torch and never jax.
"""

__version__ = "0.1.0"

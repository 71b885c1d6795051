"""K5's segmented bucket reduction (the port's segmented_reduce_affine on
the CPU: the plain affine level, then the plain segmented scan) against
the JAX package's fused reduction, msm_blst_tpu.msm.pallas_scan
.segmented_reduce: its `_seg_kernel` level in interpret mode, as the JAX
package's own tests run it, then its XLA levels and two-element merge.

2,000 elements over 300 buckets, with a point repeated inside a run (a
doubling), a cancellation inside a run and pads: the port's level (2
columns of 1,000 lanes) and its scan of 2,000 heads and tails over 16
tiles cut the stream otherwise than JAX's (16 columns of 128 lanes, then
pick_chunk levels), so the buckets agree as points: both are held to the
integer oracle's affine sums, exactly. Compiling JAX's reduction takes
most of this file's time (about 40 s), hence a file of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.msm import pallas_scan
from msm_blst_tpu_torch.convert import fp_from_jax
from msm_blst_tpu_torch.curves import G1, XyzzPoint
from msm_blst_tpu_torch.msm import cuda_scan, scan
from test_torch_seg_scan import (CPU, N_BASE, _base_ints, _oracle, _reduce,
                                 same_points)

torch.set_num_threads(1)


def test_segmented_reduce_matches_jax_fused():
    from jax.experimental.pallas import tpu as pltpu

    n, n_buckets = 2000, 300
    rng = np.random.default_rng(5)
    slots = rng.integers(0, N_BASE, n)
    slots[10:14] = slots[10]  # a repeated point: the doubling case
    keys = np.sort(rng.integers(0, n_buckets, n)).astype(np.int32)
    keys[10:14] = keys[10]
    signs = rng.integers(0, 2, n).astype(np.int32)
    signs[12] = 1 - signs[11]  # a cancellation inside a run
    keys[-5:] = n_buckets  # pads
    base = _base_ints(G1)
    assert cuda_scan.seg_level_shape(n) == (2, 1000)
    assert scan.scan_schedule(2000).n_tiles == 16
    assert pallas_scan._shape_stream(n)[:2] == (16, 128)

    jpts = JG1.affine_from_ints([base[s] for s in slots])
    with pltpu.force_tpu_interpret_mode():
        jout = jax.jit(lambda p, s, k: pallas_scan.segmented_reduce(
            JG1, p, s, k, n_buckets))(jpts, jnp.asarray(signs != 0),
                                     jnp.asarray(keys))
    want = _oracle(G1, base, slots, signs, keys, n_buckets)
    assert same_points(G1, XyzzPoint(*(fp_from_jax(np.asarray(c), CPU)
                                       for c in jout)), want)
    assert same_points(G1, _reduce(G1, base, slots, signs, keys, n_buckets),
                       want)

"""K5's plain affine level and the port's segmented bucket reduction
against the JAX package.

* seg_level_plain against JAX's Pallas `_seg_kernel` run in interpret
  mode (affine, its level 1) at the smallest shape that kernel takes
  (n_ch = blk = 128, c = 4): heads, tails and keys (the port's stream
  holds lane k's head at 2k and its tail at 2k + 1) are the same words,
  and the bucket array the port updates in place equals JAX's emissions
  scattered into an empty one. The keys are duplicate-heavy, one point
  repeats inside a run (the doubling case) and a sign cancels inside a
  run.
* segmented_reduce_affine against JAX's scan.segmented_reduce_affine at
  N = 1500 and 2048. The two cut the stream into other chunks, so the
  buckets agree as points: compared in affine, exactly.

K5's segmented scan (the xyzz part of the reduction) is held against JAX
in tests/test_torch_seg_scan.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.msm import pallas_scan
from msm_blst_tpu.msm import scan as jscan
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import G1, XyzzPoint
from msm_blst_tpu_torch.fields.limb import array_to_ints
from msm_blst_tpu_torch.msm import cuda_scan
from msm_blst_tpu_torch.msm.scan import segmented_reduce_affine

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card
W = 12
N_BASE = 24


def _base_ints():
    return [(x.v, y.v) for x, y in G1_REF.fixed_points(N_BASE)]


def _stream(n, n_buckets, seed):
    """Sorted duplicate-heavy keys (the last few are pads), slots with one
    point four times in a row inside a run, signs with a cancellation."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, N_BASE, n)
    slots[10:14] = slots[10]
    keys = np.sort(rng.integers(0, n_buckets, n)).astype(np.int32)
    keys[10:14] = keys[10]
    keys[-5:] = n_buckets
    signs = rng.integers(0, 2, n).astype(np.int32)
    signs[12] = 1 - signs[11]
    return slots, keys, signs


def _affine_ints(pt):
    """xyzz words (port tensors, W x B) -> affine ints on the host."""
    r_inv = pow(1 << 384, -1, P)
    out = []
    for x, y, zzz, zz in zip(*(array_to_ints(c.reshape(W, -1)) for c in pt)):
        if zz == 0 and zzz == 0:
            out.append((0, 0))
            continue
        zz, zzz = zz * r_inv % P, zzz * r_inv % P
        out.append((x * r_inv * pow(zz, -1, P) % P,
                    y * r_inv * pow(zzz, -1, P) % P))
    return out


@pytest.mark.parametrize("affine,c", [(True, 4)], ids=["affine"])
def test_seg_level_plain_matches_jax_kernel(affine, c):
    from jax.experimental.pallas import tpu as pltpu

    n_ch, n_buckets = 128, 96
    slots, keys, signs = _stream(c * n_ch, n_buckets, seed=c)
    base = G1.affine_from_ints(_base_ints(), device=CPU)
    # element e = j*n_ch + k is column j of lane k (the kernels' layout)
    X = base.X[:, torch.as_tensor(slots)]
    Y = base.Y[:, torch.as_tensor(slots)]
    kc = torch.as_tensor(keys.reshape(c, n_ch))
    sc = torch.as_tensor(signs.reshape(c, n_ch))
    cols = (X.T.reshape(c, n_ch, W).contiguous(),
            Y.T.reshape(c, n_ch, W).contiguous())
    jcoords = [fp_to_jax(x.reshape(W, c, n_ch)).transpose(1, 0, 2)
               for x in (X, Y)]
    jargs = jcoords + [signs.reshape(c, 1, n_ch), keys.reshape(c, 1, n_ch)]

    buckets = cuda_scan.bucket_array(G1, n_buckets, CPU)
    out, out_key = cuda_scan.seg_level_plain(G1, cols, sc, kc, buckets,
                                             n_buckets)
    head = XyzzPoint(*(x[..., 0::2] for x in out))
    tail = XyzzPoint(*(x[..., 1::2] for x in out))
    hk, tk = out_key[0::2], out_key[1::2]

    kern = pallas_scan._seg_kernel("G1", affine, c, n_ch, n_ch, n_buckets)
    with pltpu.force_tpu_interpret_mode():
        outs = [np.asarray(o) for o in kern(*(np.ascontiguousarray(a)
                                              for a in jargs))]
    em, em_key = outs[0:4], outs[4].reshape(-1)
    want = [np.zeros((2 * W, n_buckets), np.uint32) for _ in range(4)]
    keep = em_key < n_buckets
    for w, e in zip(want, em):  # (c, 2W, n_ch) -> stream order (j, k)
        w[:, em_key[keep]] = e.transpose(1, 0, 2).reshape(2 * W, -1)[:, keep]
    assert keep.sum() > 50
    for got, w in zip(buckets, want):
        assert np.array_equal(fp_to_jax(got), w)
    for got, w in zip(list(head) + list(tail), outs[5:13]):
        assert np.array_equal(fp_to_jax(got), w)
    assert np.array_equal(hk.numpy(), outs[13][0])
    assert np.array_equal(tk.numpy(), outs[14][0])


@pytest.mark.parametrize("n,n_buckets", [(2048, 48), (1500, 300)])
def test_segmented_reduce_matches_jax(n, n_buckets):
    slots, keys, signs = _stream(n, n_buckets, seed=n)
    pts_ints = [_base_ints()[s] for s in slots]
    jpts = JG1.affine_from_ints(pts_ints)
    want = jax.jit(lambda p, s, k: jscan.segmented_reduce_affine(
        JG1, JAffine(*p), s, k, n_buckets))(
            tuple(jpts), jnp.asarray(signs != 0), jnp.asarray(keys))
    want = XyzzPoint(*(fp_from_jax(np.asarray(c), CPU) for c in want))

    tpts = G1.affine_from_ints(pts_ints, device=CPU)
    got = segmented_reduce_affine(G1, tpts, torch.as_tensor(signs) != 0,
                                  torch.as_tensor(keys), n_buckets)
    assert _affine_ints(got) == _affine_ints(want)
    # and as the packed rows the engine hands it
    rows = G1.to_rows32(tpts)
    got_rows = segmented_reduce_affine(G1, rows, torch.as_tensor(signs) != 0,
                                       torch.as_tensor(keys), n_buckets)
    for a, b in zip(got_rows, got):
        assert torch.equal(a, b)

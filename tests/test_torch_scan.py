"""K3 and the scans around it against the JAX package.

* affine_prefix_level (K3's plain version) against JAX prefix_pipeline.
  local_prefix, whose per-column prefixes and tails are the same xyzz
  words after the layout change to rows.
* fold_xyzz / scan_fold_axis against JAX msm/scan, in affine.
* engine.integrate_weighted_consecutive (folds and suffix scans over the
  bucket grid) against JAX's, in affine: K <= 64 (the small path) and
  K > 64 (the grid).
* prefix_scan_xyzz / suffix_scan_xyzz (K4's plain twin; its own tests are
  in test_torch_block_scan.py) against JAX utils/scans prefix_scan
  (suffix_scan is, by its definition there, the prefix scan of the flipped
  stream, flipped back; the test forms it so to reuse one compilation).
  They associate the terms differently, so they agree as points (compared
  in affine on the host), while the port's own utils.scans.prefix_scan
  associates as JAX's does and agrees word for word.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import scan as jscan
from msm_blst_tpu.msm.prefix_pipeline import local_prefix
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu.utils import scans as jscans
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import G1, XyzzPoint
from msm_blst_tpu_torch.fields.limb import array_to_ints
from msm_blst_tpu_torch.msm import cuda_scan
from msm_blst_tpu_torch.msm.engine import integrate_weighted_consecutive
from msm_blst_tpu_torch.msm.scan import (fold_xyzz, prefix_scan_xyzz,
                                         scan_fold_axis, suffix_scan_xyzz)
from msm_blst_tpu_torch.utils import scans

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N_BASE = 12  # distinct base points; streams draw from them with repeats


def _base_points():
    rng = random.Random(3)
    gen = G1_REF.generator_jac()
    pts = []
    for _ in range(N_BASE):
        x, y = G1_REF.to_affine(G1_REF.jac_mult(rng.randrange(1, 1 << 64), gen))
        pts.append((x.v, y.v))
    return pts


def _stream(n, seed):
    """n affine point ints and signs: repeats give doublings, a point
    followed by its negation cancels, and a few lanes are infinity."""
    rng = random.Random(seed)
    base = _base_points()
    idx = [rng.randrange(N_BASE) for _ in range(n)]
    sgn = [rng.randrange(2) for _ in range(n)]
    pts = [base[i] for i in idx]
    for k in range(0, n - 3, 29):
        pts[k + 1] = pts[k]
        sgn[k + 1] = sgn[k]
        pts[k + 3] = pts[k + 2]
        sgn[k + 3] = 1 - sgn[k + 2]
    for k in range(5, n, 41):
        pts[k] = (0, 0)
    return pts, np.array(sgn, dtype=bool)


def _affine_ints(pt):
    """xyzz words (port tensors, W x B) -> affine ints on the host."""
    r_inv = pow(1 << 384, -1, P)
    X, Y, ZZZ, ZZ = (array_to_ints(c.reshape(12, -1)) for c in pt)
    out = []
    for x, y, zzz, zz in zip(X, Y, ZZZ, ZZ):
        if zz == 0 and zzz == 0:
            out.append((0, 0))
            continue
        zz, zzz = zz * r_inv % P, zzz * r_inv % P
        out.append((x * r_inv * pow(zz, -1, P) % P,
                    y * r_inv * pow(zzz, -1, P) % P))
    return out


def _port(jpt):
    return XyzzPoint(*(fp_from_jax(np.asarray(c), CPU) for c in jpt))


def test_affine_prefix_level_matches_jax_local_prefix():
    c, n_ch = 6, 16
    pts, sgn = _stream(c * n_ch, 1)
    jaff = JG1.affine_from_ints(pts)  # (24, c*n_ch), element j*n_ch + k
    cols = JAffine(*(x.reshape(24, c, n_ch).transpose(1, 0, 2) for x in jaff))
    jsg = jnp.asarray(sgn.reshape(c, n_ch))
    jlocal, jtails = jax.jit(lambda a, s: local_prefix(JG1, a, s)[:2])(cols, jsg)
    taff = G1.affine_from_ints(pts, device=CPU)
    rows_x = taff.X.T.reshape(c, n_ch, 12).contiguous()
    rows_y = taff.Y.T.reshape(c, n_ch, 12).contiguous()
    local, tails = cuda_scan.affine_prefix_level(
        G1, rows_x, rows_y, torch.as_tensor(sgn.reshape(c, n_ch)))
    # JAX local coords (c, 24, n_ch) -> port rows (c, n_ch, 12) per coord
    want_rows = torch.cat([
        fp_from_jax(np.moveaxis(np.asarray(x), 1, 0), CPU).permute(1, 2, 0)
        for x in jlocal], dim=2)
    assert torch.equal(local, want_rows)
    for got, want in zip(tails, jtails):
        assert np.array_equal(fp_to_jax(got), np.asarray(want))


def _xyzz_stream(n, seed):
    """A JAX xyzz batch with varied Z: doubled lifts of a signed stream."""
    pts, sgn = _stream(n, seed)
    lifted = JG1.xyzz_from_affine(JG1.affine_from_ints(pts),
                                  negate=jnp.asarray(sgn))
    return jax.jit(JG1.xyzz_double)(lifted)


def test_prefix_and_suffix_scans_match_jax():
    n = 256  # scan_schedule: one tile of 128 threads, two elements each
    js = _xyzz_stream(n, 4)
    tp = _port(js)
    jprefix = jax.jit(lambda p: jscans.prefix_scan(JG1.xyzz_dadd, p))
    jpre = jprefix(js)
    jsuf = jprefix(type(js)(*(x[:, ::-1] for x in js)))
    want_pre = _affine_ints(_port(jpre))
    want_suf = _affine_ints(_port(jsuf))[::-1]
    assert _affine_ints(prefix_scan_xyzz(G1, tp)) == want_pre
    assert _affine_ints(suffix_scan_xyzz(G1, tp)) == want_suf
    # same chunking as JAX's utils/scans: the same words
    same = scans.prefix_scan(G1.xyzz_dadd, tp)
    for g, w in zip(same, jpre):
        assert np.array_equal(fp_to_jax(g), np.asarray(w))
    # the last running sum is the fold of the whole stream
    assert want_pre[-1] == _affine_ints(fold_xyzz(G1, tp))[0]


def test_folds_match_jax():
    rows, cols = 3, 16
    js = _xyzz_stream(rows * cols, 5)
    grid = type(js)(*(x.reshape(24, rows, cols) for x in js))
    tgrid = XyzzPoint(*(fp_from_jax(np.asarray(x), CPU) for x in grid))
    for axis in (-1, -2):
        want = jax.jit(lambda g, a=axis: jscan.scan_fold_axis(JG1, g, a))(grid)
        got = scan_fold_axis(G1, tgrid, axis)
        assert _affine_ints(got) == _affine_ints(_port(want))
    want = jax.jit(lambda p: jscan.fold_xyzz(JG1, p))(js)
    assert _affine_ints(fold_xyzz(G1, _port(js))) == _affine_ints(_port(want))


@pytest.mark.parametrize("K", [40, 100])
def test_integrate_weighted_consecutive_matches_jax(K):
    js = _xyzz_stream(K, 6)
    want = jax.jit(lambda b: jengine.integrate_weighted_consecutive(JG1, b))(js)
    got = integrate_weighted_consecutive(G1, _port(js))
    assert _affine_ints(got) == _affine_ints(_port(want))

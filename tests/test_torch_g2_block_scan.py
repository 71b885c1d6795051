"""K4's plain twin over G2 (msm/scan.py prefix_scan_xyzz_plain, Fp2
coordinates) against JAX's G2 group law, in affine, on the CPU.

A 70-point stream that starts P, P, -2P (the running sum doubles, then
cancels), repeats a point at 10, 11, follows a point by its negation at
12, 13 and holds infinity every 23rd lane from 7. It is scanned by the
twin at two schedules: one tile of 128 threads, and seven tiles of a
4-thread block whose carry pass takes two totals a thread (a wave of
eight, patched in as in test_torch_block_scan.py).

JAX's side is a Hillis-Steele scan of jax.jit(G2.xyzz_dadd): one
compilation of the add (about 20 s here) and seven calls. JAX's
utils/scans.prefix_scan over G2 traces the add three times and compiles
for about 50 s, more than this file's minute. The sums associate otherwise
than the twin's, so the two agree as points, not as xyzz words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G2 as JG2
from msm_blst_tpu.curves.ops import XyzzPoint as JXyzz
from msm_blst_tpu_torch.convert import fp2_from_jax, fp2_to_jax
from msm_blst_tpu_torch.curves import G2, XyzzPoint
from msm_blst_tpu_torch.msm import fixed_point_list, scan

torch.set_num_threads(1)
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 70


def _stream():
    base = G2.xyzz_double(G2.xyzz_from_affine(
        fixed_point_list(G2, 8, device=CPU)))
    idx = torch.as_tensor(np.random.default_rng(7).integers(0, 8, N))
    pts = XyzzPoint(*(c[..., idx].clone() for c in base))
    two = G2.xyzz_double(XyzzPoint(*(c[..., :1] for c in pts)))
    for c, d in zip(pts, two):
        c[..., 1] = c[..., 0]
        c[..., 2:3] = d
        c[..., 11] = c[..., 10]
        c[..., 13] = c[..., 12]
        c[..., 7::23] = 0
    for i in (2, 13):
        pts.Y[..., i:i + 1] = G2.F.neg(pts.Y[..., i:i + 1])
    return pts


def _jax_prefix(pts):
    """Inclusive prefix sums by JAX's G2 xyzz_dadd, log2 N levels."""
    dadd = jax.jit(JG2.xyzz_dadd)
    acc = JXyzz(*(jnp.asarray(fp2_to_jax(c)) for c in pts))
    d = 1
    while d < N:
        pad = [(0, 0)] * (acc.X.ndim - 1) + [(d, 0)]
        earlier = JXyzz(*(jnp.pad(c[..., :-d], pad) for c in acc))
        acc = dadd(earlier, acc)
        d *= 2
    return XyzzPoint(*(fp2_from_jax(np.asarray(c), CPU) for c in acc))


def _affine(p):
    return G2.affine_to_ints(G2.jac_to_affine(G2.xyzz_to_jac(p)))


@pytest.fixture(scope="module")
def stream():
    """The port's stream and JAX's prefix sums of it, in affine."""
    pts = _stream()
    return pts, _affine(_jax_prefix(pts))


@pytest.mark.parametrize("threads, wave, schedule", [
    (scan.FOLD_THREADS, scan.FOLD_WAVE, scan.ScanSchedule(1, 1, 0)),
    (4, 8, scan.ScanSchedule(3, 6, 2)),
])
def test_prefix_scan_g2_plain_matches_jax(stream, monkeypatch, threads,
                                          wave, schedule):
    pts, want = stream
    monkeypatch.setattr(scan, "FOLD_THREADS", threads)
    monkeypatch.setattr(scan, "FOLD_WAVE", wave)
    scan.scan_schedule.cache_clear()
    try:
        assert scan.scan_schedule(N) == schedule
        got = scan.prefix_scan_xyzz_plain(G2, pts)
    finally:
        scan.scan_schedule.cache_clear()
    assert got.X.shape == pts.X.shape
    assert want[2] == ((0, 0), (0, 0))  # P + P - 2P: infinity
    assert _affine(got) == want

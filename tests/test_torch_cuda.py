"""The port's CUDA kernels on a card: each against its plain version, and
the CHES query against the oracle. Every test takes the `dev` fixture,
which skips it without a CUDA device. On a machine with one:

    python -m pytest --noconftest tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX, which that machine need
not have; these tests import no JAX.)
"""

import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P, R_ORDER
from msm_blst_tpu.refimpl import G1_REF


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _points(n, dev):
    from msm_blst_tpu_torch.curves import G1

    return G1.affine_from_ints(
        [(x.v, y.v) for x, y in G1_REF.fixed_points(n)], device=dev)


def test_mont_mul_kernel_matches_plain(dev):
    from msm_blst_tpu_torch.fields import FP, cuda_mont

    rng = np.random.default_rng(1)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(1000)]
    xs[:3] = [0, 1, P - 1]
    a = FP.from_ints(xs, device=dev)
    b = FP.from_ints(xs[::-1], device=dev)
    got = cuda_mont.mont_mul(a, b, FP)
    assert torch.equal(got, cuda_mont.mont_mul_plain(a, b, FP))
    assert torch.equal(got.cpu(), cuda_mont.mont_mul(a.cpu(), b.cpu(), FP))


def test_point_kernels_match_plain(dev):
    from msm_blst_tpu_torch.curves import G1, cuda_point

    B = 64
    pts = _points(B, dev)
    lane = torch.arange(B, device=dev)
    base = G1.xyzz_from_affine(pts)
    acc = G1.select(lane == 0, G1.xyzz_inf((B,), dev), G1.xyzz_double(base))
    acc = G1.select((lane == 1) | (lane == 2), base, acc)
    signs = lane % 3 == 2
    other = G1.xyzz_from_affine(pts, negate=signs)
    pairs = [
        (cuda_point.xyzz_dadd_affine(G1, acc, pts, signs),
         cuda_point.xyzz_dadd_affine_plain(G1, acc, pts, signs)),
        (cuda_point.xyzz_dadd(G1, acc, other),
         cuda_point.xyzz_dadd_plain(G1, acc, other)),
        (cuda_point.xyzz_double(G1, acc), cuda_point.xyzz_double_plain(G1, acc)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_scan_kernels_match_plain(dev):
    from msm_blst_tpu_torch.curves import G1, XyzzPoint
    from msm_blst_tpu_torch.msm import cuda_scan

    c, n_ch = 7, 256
    rows = G1.to_rows32(_points(32, dev)).XY
    rng = np.random.default_rng(2)
    g = rows[torch.as_tensor(rng.integers(0, 32, size=c * n_ch), device=dev)]
    rx = g[:, :12].reshape(c, n_ch, 12).contiguous()
    ry = g[:, 12:].reshape(c, n_ch, 12).contiguous()
    sg = torch.as_tensor(rng.integers(0, 2, size=(c, n_ch)), device=dev)
    local, tails = cuda_scan.affine_prefix_level(G1, rx, ry, sg)
    wl, wt = cuda_scan.affine_prefix_level_plain(G1, rx, ry, sg)
    assert torch.equal(local, wl)
    assert all(torch.equal(a, b) for a, b in zip(tails, wt))
    cols = XyzzPoint(*(local.reshape(c, n_ch, 4, 12)[:, :, i].permute(0, 2, 1)
                       .contiguous() for i in range(4)))
    got = cuda_scan.xyzz_scan_level(G1, cols)
    want = cuda_scan.xyzz_scan_level_plain(G1, cols)
    for gp, wp in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(gp, wp))


def test_msm_ches_device_on_the_card(dev):
    from msm_blst_tpu_torch.curves import G1
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_ches_device, params, recode)

    n = 64
    plan = build_plan(G1, fixed_point_list(G1, n, device=dev),
                      params.make_config(6, c=8, h=32))
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed=1))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    jac = msm_ches_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), dev))
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    assert G1.affine_to_ints(G1.jac_to_affine(jac))[0] == (x.v, y.v)

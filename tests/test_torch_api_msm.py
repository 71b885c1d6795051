"""The port's facade MSMs over G1 on the CPU (device="cpu"): CHES and BGMW95
through the blst names, against the reference binary's golden vectors
(tests/fixtures/golden_msm.json, G1 n = 64) and the oracle; the plan memo
(the BGMW call upgrades the CHES plan in place, a repeat call builds
nothing); the stale-plan hole of the JAX facade (its digest probes 16
positions, so a point changed elsewhere in the same list keeps the old
plan) shown on JAX's digest and closed in the port; _facade_config and the
integral scalar conversion against JAX's; and the card as the default
device. G2: tests/test_torch_api_msm_g2.py; the batch ops (stock, tile,
wbits, add, to-affine): tests/test_torch_api_batch.py.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import msm_blst_tpu.api as J
from msm_blst_tpu.curves import serialize
from msm_blst_tpu_torch import api
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import fixed_point_list, params, recode
from msm_blst_tpu_torch.refimpl import G1 as ref

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden_msm.json"


def _golden(group: int, n: int):
    return next(c for c in json.loads(GOLDEN.read_text())
                if c["group"] == group and c["n"] == n)


CASE = _golden(1, 64)
N = CASE["n"]


def _oracle(ints, weights):
    return ref.mult(sum(s * e for s, e in zip(ints, weights)) % R_ORDER)


@pytest.fixture(scope="module")
def points():
    """The reference's points P_i = 2^(i+1) G as host int pairs."""
    return G1.affine_to_ints(fixed_point_list(G1, N, device=CPU))


@pytest.fixture(scope="module")
def weights():
    return [pow(2, i + 1, R_ORDER) for i in range(N)]


@pytest.fixture(scope="module")
def ches_first(points):
    """The first CHES call on the golden case: (its result, the memo's
    plan)."""
    api._PLAN_CACHE.clear()
    ints = recode.scalars_to_ints(recode.random_scalars(N, CASE["seed"]))
    jac = api.p1_tile_pippenger_d_CHES(points, ints, device=CPU)
    return jac, api._ches_plan(G1, points, device=CPU)


def test_ches_matches_golden_and_oracle(ches_first, points, weights):
    jac, plan = ches_first
    ints = recode.scalars_to_ints(recode.random_scalars(N, CASE["seed"]))
    aff = api.p1_to_affine(jac)
    assert aff == _oracle(ints, weights)
    assert serialize.g1_serialize(aff).hex() == CASE["serialized"]
    assert plan.cfg == api._facade_config(N)  # CONFIGS[8]'s radix
    assert plan.table3nh is not None and plan.table_nh is None


def test_bgmw_upgrades_the_plan_in_place(ches_first, points, weights,
                                         monkeypatch):
    """CONFIGS[8]'s radixes differ (c 12, c' 10): the BGMW call adds the nh
    table to the memo's plan and keeps the 3nh table's object; the CHES
    call after it builds nothing."""
    _, plan = ches_first
    table = plan.table3nh
    ints = recode.scalars_to_ints(recode.random_scalars(N, CASE["seed"]))
    jac = api.p1_tile_pippenger_BGMW95(points, ints, device=CPU)
    assert serialize.g1_serialize(api.p1_to_affine(jac)).hex() == \
        CASE["serialized"]
    same = api._ches_plan(G1, points, device=CPU)
    assert same is plan and same.table3nh is table
    assert same.table_nh is not None and not same.bgmw_stride3
    assert tuple(same.table_nh.XY.shape) == (N * plan.cfg.h_bgmw, 24)

    def no_build(*args, **kwargs):
        raise AssertionError("a memo hit built a plan")
    monkeypatch.setattr(api, "build_plan", no_build)
    ks = [1] * N
    ks[0], ks[1], ks[2] = 0, R_ORDER - 1, 1 << 200
    got = api.p1_tile_pippenger_d_CHES(list(points), ks, device=CPU)
    assert api.p1_to_affine(got) == _oracle(ks, weights)


def test_stale_plan_hole_is_closed(ches_first, points, weights):
    """Fault C2 of the JAX facade: a point replaced at position 1 of the
    same list object, a position its 16 probes (0, 4, ..., 60) never read,
    leaves JAX's digest stale; the port hashes every point on every call,
    so its next CHES call builds the new points' plan and equals the new
    oracle."""
    pts = list(points)
    probes = tuple(range(0, N, max(1, N // 16)))[:16]
    assert 1 not in probes
    stale = J._points_digest(pts)
    pts[1] = api.p1_affine_generator()  # G in place of P_1 = 4G
    assert J._points_digest(pts) == stale  # JAX's stale plan key
    assert J._points_digest(list(pts)) != stale  # a fresh list: new value
    assert api._points_digest(pts) != api._points_digest(points)
    ints = recode.scalars_to_ints(recode.random_scalars(N, 3))
    w = list(weights)
    w[1] = 1
    got = api.p1_tile_pippenger_d_CHES(pts, ints, device=CPU)
    assert api.p1_to_affine(got) == _oracle(ints, w)
    assert api.p1_to_affine(got) != _oracle(ints, weights)


@pytest.mark.parametrize("n", [1, 2, 16, 64, 100, 255, 256, 1000, 1 << 14,
                               1 << 16, 100_000, 1 << 17, (1 << 20) + 5,
                               1 << 21, 1 << 22])
def test_facade_config_matches_jax(n):
    got, want = api._facade_config(n), J._facade_config(n)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if n == 100_000:  # the nearest shipped radix, CONFIGS[16]'s
        assert (got.c, got.h, got.c_bgmw) == (19, 14, 17)


@pytest.mark.parametrize("n, key", [(64, None), (300, 16), (1 << 12, None)])
@pytest.mark.parametrize("g", ["p1", "p2"])
def test_construct_nh_scalars_matches_jax(n, key, g):
    """The integral scalar conversion (native) equals JAX's: bucket values,
    signs and point slots, on scalars with 0, r - 1, r and 2^256 - 1."""
    ints = recode.scalars_to_ints(recode.random_scalars(n, 11))
    ints[:4] = [0, R_ORDER - 1, R_ORDER, (1 << 256) - 1]
    cfg = None if key is None else params.CONFIGS[key]
    jcfg = None if key is None else J.params.CONFIGS[key]
    fn = f"{g}_construct_nh_scalars_nh_points"
    got = getattr(api, fn)(ints, cfg)
    want = getattr(J, fn)(ints, jcfg)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


_NO_CARD = """
from msm_blst_tpu_torch import api
g1, g2 = api.p1_affine_generator(), api.p2_affine_generator()
j1, j2 = api.p1_generator(), api.p2_generator()
calls = {
    "p1s_to_affine": lambda: api.p1s_to_affine([j1]),
    "p2s_to_affine": lambda: api.p2s_to_affine([j2]),
    "p1s_add": lambda: api.p1s_add([g1]),
    "p2s_add": lambda: api.p2s_add([g2]),
    "p1s_mult_pippenger": lambda: api.p1s_mult_pippenger([g1], [3]),
    "p2s_mult_pippenger": lambda: api.p2s_mult_pippenger([g2], [3]),
    "p1s_tile_pippenger": lambda: api.p1s_tile_pippenger([g1], [3], 4),
    "p2s_tile_pippenger": lambda: api.p2s_tile_pippenger([g2], [3], 4),
    "p1s_mult_wbits_precompute": lambda: api.p1s_mult_wbits_precompute([g1], 4),
    "p2s_mult_wbits_precompute": lambda: api.p2s_mult_wbits_precompute([g2], 4),
    "p1s_mult_wbits": lambda: api.p1s_mult_wbits(None, [3], 4),
    "p2s_mult_wbits": lambda: api.p2s_mult_wbits(None, [3], 4),
    "p1_tile_pippenger_d_CHES": lambda: api.p1_tile_pippenger_d_CHES([g1], [3]),
    "p2_tile_pippenger_d_CHES": lambda: api.p2_tile_pippenger_d_CHES([g2], [3]),
    "p1_tile_pippenger_BGMW95": lambda: api.p1_tile_pippenger_BGMW95([g1], [3]),
    "p2_tile_pippenger_BGMW95": lambda: api.p2_tile_pippenger_BGMW95([g2], [3]),
}
for name, call in calls.items():
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), (name, e)
        print(name)
    else:
        raise AssertionError(name + " ran without a card")
"""


def test_card_entries_default_to_the_card():
    """Without `device`, every entry that touches the card raises when
    torch sees none; none carries on on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-c", _NO_CARD], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.split()) == 16

"""The port's facade MSMs over G2 on the CPU (device="cpu"): CHES and
BGMW95 through the blst names at the reference binary's G2 golden vector
(tests/fixtures/golden_msm.json, n = 64), against the serialized golden
bytes and the oracle. Each call builds its own tables (CONFIGS[8]'s radix,
c 12 and c' 10 differ): the G2 CHES plan build and query take about 30 s
of this file on the CPU, BGMW about 15 s. G1: tests/test_torch_api_msm.py.
"""

import json
from pathlib import Path

import pytest
import torch

from msm_blst_tpu.curves import serialize
from msm_blst_tpu_torch import api
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.curves import G2
from msm_blst_tpu_torch.msm import fixed_point_list, recode
from msm_blst_tpu_torch.refimpl import G2 as ref

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card
GOLDEN = Path(__file__).parent / "fixtures" / "golden_msm.json"
CASE = next(c for c in json.loads(GOLDEN.read_text())
            if c["group"] == 2 and c["n"] == 64)
N = CASE["n"]


@pytest.fixture(scope="module")
def inputs():
    """The reference's points P_i = 2^(i+1) G as host int tuples, the
    golden case's scalars and the oracle's point."""
    points = G2.affine_to_ints(fixed_point_list(G2, N, device=CPU))
    ints = recode.scalars_to_ints(recode.random_scalars(N, CASE["seed"]))
    want = ref.mult(sum(s * pow(2, i + 1, R_ORDER)
                        for i, s in enumerate(ints)) % R_ORDER)
    return points, ints, want


@pytest.mark.parametrize("entry", ["p2_tile_pippenger_d_CHES",
                                   "p2_tile_pippenger_BGMW95"])
def test_g2_facade_matches_golden_and_oracle(inputs, entry):
    points, ints, want = inputs
    api._PLAN_CACHE.clear()  # each entry builds its own tables
    aff = api.p2_to_affine(getattr(api, entry)(points, ints, device=CPU))
    assert aff == want
    assert serialize.g2_serialize(aff).hex() == CASE["serialized"]
    plan = api._ches_plan(G2, points, ches=False, device=CPU)
    assert (plan.table3nh is None) == (entry.endswith("BGMW95"))
    api._PLAN_CACHE.clear()

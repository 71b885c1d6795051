"""The port's G2 MSMs end to end: CHES (device and host recode) and BGMW95,
each with both bucket strategies, against the pure-integer G2 oracle and
the reference binary's G2 golden vectors, and (one `slow` test) against the
JAX package's own G2 queries. Stock Pippenger over G2:
tests/test_torch_g2_stock.py.

* Oracle: n = 16 with tests/test_msm.py's test_g2_agreement config and
  scalars (c=8, h=32, c'=8, h'=32: BGMW reads the 3nh table's m=1 rows;
  scalars 0, r-1 and a repeated pair). refimpl.G2 is held equal to the JAX
  package's G2_REF by tests/test_torch_fp2.py.
* Golden: tests/fixtures/golden_msm.json's group-2 cases at n = 64 and 128
  (blst's own output, which tests/test_golden.py holds the JAX engine to),
  through one CHES plan at n = 128 (c=8, h=32); the n = 64 case pads its
  scalars with zeros, which add nothing to the sum. The result is
  serialized with the JAX package's g2_serialize and compared byte for
  byte. The plan's table is assembled from fixed points rather than built
  by the doubling chain, whose 256 doublings at this width take the plain
  G2 formulas about a minute on the CPU: row (i, j, m) holds
  m * 2^(8j) * P_i = m * 2^(8j+i+1) * G, so with P_k = 2^(k+1) * G it is
  P_(e-1), P_e or P_(e-1) + P_e for e = 8j + i + 1. Its first n = 16 points'
  rows equal build_plan's table of the oracle tests, word for word.

All comparisons are exact (affine coordinates or serialized bytes).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import serialize
from msm_blst_tpu_torch.convert import plan_from_jax
from msm_blst_tpu_torch.curves import G2, AffinePoint
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_bgmw_device, msm_ches_device,
                                    msm_ches_host_recode, params, recode)
from msm_blst_tpu_torch.refimpl import G2 as ref

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
CFG = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)
IMPLS = ("prefix", "segmented")
GOLDEN = Path(__file__).parent / "fixtures" / "golden_msm.json"


def _query_ints():
    """tests/test_msm.py test_g2_agreement's scalars."""
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=21))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    return ints


def _oracle(ints):
    return ref.mult(sum(s * pow(2, i + 1, R_ORDER)
                        for i, s in enumerate(ints)) % R_ORDER)


def _affine(jac):
    return G2.affine_to_ints(G2.jac_to_affine(jac))[0]


@pytest.fixture(scope="module")
def plan():
    return build_plan(G2, fixed_point_list(G2, N, device=CPU),
                      params.make_config(4, **CFG))


def test_g2_plan_aliases_the_bgmw_table(plan):
    """Matching radixes: no nh table, BGMW reads the 3nh table's m=1 rows;
    48-word rows (192 B a point)."""
    assert plan.bgmw_stride3 and plan.table_nh is None
    assert tuple(plan.table3nh.XY.shape) == (3 * N * 32, 48)
    assert tuple(plan.points_rows.XY.shape) == (N, 48)


@pytest.mark.parametrize("impl", IMPLS)
def test_g2_msm_ches_device_matches_oracle(plan, impl):
    ints = _query_ints()
    jac = msm_ches_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), CPU), bucket_impl=impl)
    assert _affine(jac) == _oracle(ints)


@pytest.mark.parametrize("impl", IMPLS)
def test_g2_msm_ches_host_recode_matches_oracle(plan, impl):
    ints = _query_ints()
    jac = msm_ches_host_recode(plan, recode.scalars_from_ints(ints),
                               bucket_impl=impl)
    assert _affine(jac) == _oracle(ints)


@pytest.mark.parametrize("impl", IMPLS)
def test_g2_msm_bgmw_device_matches_oracle(plan, impl):
    ints = _query_ints()
    jac = msm_bgmw_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), CPU), bucket_impl=impl)
    assert _affine(jac) == _oracle(ints)


def _golden_cases():
    return [c for c in json.loads(GOLDEN.read_text())
            if c["group"] == 2 and c["n"] <= 128]


@pytest.fixture(scope="module")
def golden_plan():
    """A CHES plan over P_0 .. P_(n-1), n = 128, c=8, h=32, its 3nh table
    assembled from fixed points (see the module docstring)."""
    n = max(c["n"] for c in _golden_cases())
    cfg = params.make_config(n.bit_length() - 1, c=8, h=32)
    e_max = cfg.c * (cfg.h - 1) + n  # the largest e = c*j + i + 1
    pts = fixed_point_list(G2, e_max + 1, device=CPU)  # P_k, k <= e_max
    threes = G2.xyzz_to_affine(G2.xyzz_dadd_affine(
        G2.xyzz_from_affine(AffinePoint(*(x[..., :-1] for x in pts))),
        AffinePoint(*(x[..., 1:] for x in pts))))  # P_k + P_(k+1)
    ones, threes = G2.to_rows32(pts).XY, G2.to_rows32(threes).XY
    e = (cfg.c * torch.arange(cfg.h)[None, :]
         + torch.arange(n)[:, None] + 1).reshape(-1)  # (i, j) order
    table = torch.stack([ones[e - 1], ones[e], threes[e - 1]], dim=1)
    return plan_from_jax({
        "table3nh": table.reshape(-1, 48).numpy().view(np.uint32),
        "packed_table": params.packed_digit_table_pairs(cfg.q, cfg.ah),
        "bucket_gaps": np.diff(cfg.bucket_set())}, cfg, curve=G2, device=CPU)


def test_g2_golden_table_matches_build_plan(plan, golden_plan):
    rows = plan.table3nh.XY.shape[0]
    assert torch.equal(golden_plan.table3nh.XY[:rows], plan.table3nh.XY)


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: f"n{c['n']}")
def test_g2_msm_matches_blst_golden(golden_plan, case):
    n_plan = max(c["n"] for c in _golden_cases())
    sc = np.zeros((8, n_plan), dtype=np.uint32)
    sc[:, :case["n"]] = recode.random_scalars(case["n"], seed=case["seed"])
    x, y = _affine(msm_ches_device(golden_plan, recode.to_device(sc, CPU)))
    assert serialize.g2_serialize((x, y)).hex() == case["serialized"]


@pytest.mark.slow
def test_g2_agreement_with_jax(plan):
    """The whole G2 query, port and JAX package side by side: msm_ches_device
    and msm_bgmw_device on tests/test_msm.py test_g2_agreement's inputs, the
    port's plan carried over from the JAX plan (convert.plan_from_jax) and
    built by the port, all four results equal in affine. Slow: JAX's G2
    query graphs take many minutes to compile on the CPU."""
    import jax
    import jax.numpy as jnp

    from msm_blst_tpu.curves import G2 as JG2
    from msm_blst_tpu.msm import build_plan as j_build_plan
    from msm_blst_tpu.msm import engine as jengine
    from msm_blst_tpu.msm import fixed_point_list as j_fixed_point_list
    from msm_blst_tpu.msm import params as jparams

    jplan = j_build_plan(JG2, j_fixed_point_list(JG2, N),
                         jparams.make_config(4, **CFG))
    ported = plan_from_jax({"table3nh": np.asarray(jplan.table3nh.XY),
                            "packed_table": np.asarray(jplan.packed_table),
                            "bucket_gaps": jplan.bucket_gaps,
                            "bgmw_stride3": jplan.bgmw_stride3},
                           params.make_config(4, **CFG), curve=G2, device=CPU)
    ints = _query_ints()
    sc = recode.scalars_from_ints(ints)
    jsc = jnp.asarray(sc)
    want = [JG2.affine_to_ints(JG2.jac_to_affine(jax.jit(
        lambda s, f=f: f(jplan, s))(jsc)))[0]
        for f in (jengine.msm_ches_device, jengine.msm_bgmw_device)]
    assert want == [_oracle(ints)] * 2
    for p in (ported, plan):
        got = [_affine(f(p, recode.to_device(sc, CPU)))
               for f in (msm_ches_device, msm_bgmw_device)]
        assert got == want

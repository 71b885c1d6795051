"""The port's big-n pieces on the CPU (plain versions), against the
pure-integer oracle and the JAX package (the streamed builders' rows
against JAX's: tests/test_torch_bign_rows.py; the queries against JAX's
on one plan: tests/test_torch_bign_jax.py).

* build_plan(streamed=True) (c = 8, h = 32, n = 16) gives the window-major
  "j" layout: its rows are the "i" builder's rows permuted, and a plan of
  CHES and BGMW with one radix aliases the BGMW table into the 3nh table
  (stride 3) as the "i" plan does; streamed=None streams from n = 2^17.
* bucket_sums_prefix split by position (chunks=3) equals one pass;
  segment_starts equals JAX's.
* On the "j" plan: msm_ches_device, msm_ches_host_recode and
  msm_bgmw_device, and msm_bign (CHES and BGMW95) at the chunk count of
  the CPU (one), at 3 and at counts that leave bucket ranges empty, equal
  the oracle (sum s_i 2^(i+1) mod r) * G on the scalars 0, r - 1 and a
  repeated one.
* G2: the streamed rows are the "i" rows permuted (two windows, the points
  in two parts), and msm_bign at 3 chunks equals the oracle (JAX's G2
  graphs compile for minutes on a CPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.msm import prefix_pipeline as jpp
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.curves import G1, G2
from msm_blst_tpu_torch.msm import (build_ches_table_rows_streamed,
                                    build_plan, engine, fixed_point_list,
                                    msm_bgmw_device, msm_bign,
                                    msm_ches_device, msm_ches_host_recode,
                                    params, prefix_pipeline, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
CFG = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)  # aliased: BGMW reads 3nh


def _ints(n=N, seed=61):
    """Scalars with 0, r - 1 and a repeated scalar."""
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    return ints


def _oracle(curve, ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    return refimpl.CURVES[curve.name].mult(total)


def _affine(curve, jac):
    return curve.affine_to_ints(curve.jac_to_affine(jac))[0]


def _two_windows(cfg):
    """cfg cut to two windows (the builders read only c and h)."""
    return dataclasses.replace(cfg, h=2, h_bgmw=2)


def _permuted(curve, points, cfg, i_plan, j_rows):
    """The "j" rows equal the "i" plan's rows of the same entries."""
    n = points.X.shape[-1]
    i_, j_, m1 = np.meshgrid(np.arange(n), np.arange(cfg.h), np.arange(3),
                             indexing="ij")
    si = engine.ches_slots(i_, j_, m1, cfg.h, n, "i").reshape(-1)
    sj = engine.ches_slots(i_, j_, m1, cfg.h, n, "j").reshape(-1)
    return torch.equal(i_plan.table3nh.XY[torch.as_tensor(si)],
                       j_rows[torch.as_tensor(sj)])


@pytest.fixture(scope="module")
def points():
    return fixed_point_list(G1, N, device=CPU)


@pytest.fixture(scope="module")
def plan(points):
    return build_plan(G1, points, params.make_config(4, **CFG), streamed=True,
                      stock=False)


def test_j_rows_are_the_i_rows_permuted(points, plan):
    i_plan = build_plan(G1, points, plan.cfg, bgmw=False, stock=False,
                        streamed=False)
    assert plan.layout == "j" and i_plan.layout == "i"
    assert _permuted(G1, points, plan.cfg, i_plan, plan.table3nh.XY)


def test_streamed_plan_aliases_bgmw(points, plan):
    assert plan.bgmw_stride3 and plan.table_nh is None
    table, slots = engine.bgmw_table_slots(plan, torch.arange(5))
    assert table is plan.table3nh and torch.equal(slots, 3 * torch.arange(5))
    # a BGMW-only plan builds the nh table: the aliased plan's m=1 rows
    cfg = _two_windows(plan.cfg)
    both = build_plan(G1, points, cfg, stock=False, streamed=True)
    own = build_plan(G1, points, cfg, ches=False, stock=False, streamed=True)
    assert both.bgmw_stride3 and not own.bgmw_stride3 and own.layout == "j"
    assert torch.equal(own.table_nh.XY, both.table3nh.XY[0::3])


def _stream(plan, ints):
    sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
    slots, keys, signs = engine._ches_streams(plan, sc)
    return engine._sort_stream(slots, keys, signs), plan.cfg.b_size


def test_position_chunks_equal_one_pass(plan):
    (keys_s, slots_s, signs_s), nb = _stream(plan, _ints())
    one = prefix_pipeline.bucket_sums_prefix(G1, plan.table3nh, slots_s,
                                             signs_s, keys_s, nb)
    three = prefix_pipeline.bucket_sums_prefix(G1, plan.table3nh, slots_s,
                                               signs_s, keys_s, nb, chunks=3)
    to_aff = lambda b: G1.affine_to_ints(G1.jac_to_affine(G1.xyzz_to_jac(b)))  # noqa: E731
    assert to_aff(one) == to_aff(three)


@pytest.mark.parametrize("K", [1, 3, 7, 64])
def test_segment_starts_match_jax(plan, K):
    (keys_s, _, _), nb = _stream(plan, _ints())
    starts, W = prefix_pipeline.segment_starts(keys_s, nb, K)
    jstarts, jW = jpp.segment_starts(jnp.asarray(keys_s.numpy()), nb, K)
    assert W == jW and starts.dtype == torch.int32
    assert np.array_equal(starts.numpy(), np.asarray(jstarts))


def _empty_range_count(keys_s, nb):
    """The fewest chunks (from 2) whose bucket ranges leave one empty."""
    for K in range(2, nb):
        starts, _ = prefix_pipeline.segment_starts(keys_s, nb, K)
        if bool((starts[1:] == starts[:-1]).any()):
            return K
    raise AssertionError("no chunk count leaves a range empty")


def test_j_plan_queries_match_oracle(plan):
    ints = _ints()
    host = recode.scalars_from_ints(ints)
    sc = recode.to_device(host, CPU)
    want = _oracle(G1, ints)
    assert _affine(G1, msm_ches_device(plan, sc)) == want
    assert _affine(G1, msm_ches_host_recode(plan, host)) == want
    assert _affine(G1, msm_bgmw_device(plan, sc)) == want


@pytest.mark.parametrize("algo", ["ches", "bgmw"])
def test_msm_bign_matches_oracle(plan, algo):
    """One chunk (the CPU's count), three, and the fewest chunks that leave
    a bucket range empty."""
    ints = _ints()
    sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
    if algo == "ches":
        (keys_s, _, _), nb = _stream(plan, ints)
    else:
        keys_s = engine._sort_stream(*engine._bgmw_streams(plan, sc)[1:])[0]
        nb = (plan.cfg.q_bgmw >> 1) + 1
    empty = _empty_range_count(keys_s, nb)
    want = _oracle(G1, ints)
    for K in (None, 3, empty):
        assert _affine(G1, msm_bign(plan, sc, algo, n_chunks=K)) == want, K


def test_bgmw_bign_with_empty_ranges(plan):
    """Scalars below 2^20: every digit above the third window is 0, so
    several of 16 bucket ranges hold no digit at all."""
    ints = [s % (1 << 20) for s in _ints(seed=62)]
    sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
    keys_s = engine._sort_stream(*engine._bgmw_streams(plan, sc)[1:])[0]
    starts, _ = prefix_pipeline.segment_starts(
        keys_s, (plan.cfg.q_bgmw >> 1) + 1, 16)
    assert int((starts[1:] == starts[:-1]).sum()) >= 4
    assert _affine(G1, msm_bign(plan, sc, "bgmw", n_chunks=16)) == \
        _oracle(G1, ints)


def test_g2_streamed_rows_and_bign():
    n = 8
    pts = fixed_point_list(G2, n, device=CPU)
    cfg = params.make_config(3, **CFG)
    i_plan = build_plan(G2, pts, cfg, stock=False, streamed=False)
    small = _two_windows(cfg)
    rows = build_ches_table_rows_streamed(G2, pts, small, parts=2).XY
    i_small = build_plan(G2, pts, small, bgmw=False, stock=False,
                         streamed=False)
    assert _permuted(G2, pts, small, i_small, rows)
    ints = _ints(n, seed=63)
    sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
    for algo in ("ches", "bgmw"):
        assert _affine(G2, msm_bign(i_plan, sc, algo, n_chunks=3)) == \
            _oracle(G2, ints), algo


def test_streamed_defaults_on_from_2_17():
    one = fixed_point_list(G1, 1, device=CPU)
    cfg = params.make_config(1, **CFG)
    assert build_plan(G1, one, cfg, ches=False, bgmw=False).layout == "i"
    big = type(one)(*(x.expand(12, 1 << 17) for x in one))
    assert build_plan(G1, big, cfg, ches=False, bgmw=False).layout == "j"

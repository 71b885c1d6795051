"""The port's sharded MSM against the JAX package's (msm_blst_tpu/parallel).

The port's side: one spawn of 4 gloo ranks (test_torch_sharded.rank_cases,
a FileStore under pytest's tmp_path) running the cases below. The JAX
side: tests/test_sharded.py's configs, 8-device meshes, plans and seeds,
so that JAX's persistent compile cache serves both files; each JAX plan is
built once and each function traced once. Points are compared as affine
words.

* ec_allreduce_xyzz on 4 ranks equals JAX's under shard_map on a
  4-device "points" mesh, word for word on every rank, on G1 xyzz batches
  whose lanes reach the infinity, doubling and cancelling cases of the
  dadd.
* sharded_msm_ches (points axis), sharded_msm_bgmw (points axis, the
  stride-3 aliased table) and sharded_msm_ches_windows (a "j" plan with h
  = 33, padded) equal the port's on every rank.
* ches_recode_device (the unpacked tables) equals JAX's, word for word,
  over seeded and edge scalars.
* C6: at make_config(3, c=8, h=32, c_bgmw=5, h_bgmw=51) (c'h' = 255: the r
  - a fold) on 8 points over a 2-device mesh, with scalars in [r, 2^255),
  JAX's points-sharded BGMW differs from the oracle (it folds without
  reducing mod r first) while its msm_bgmw_device and the port's sharded
  BGMW equal it.

The four tests that run JAX's whole sharded queries are `slow`: on an
8-core x86 CPU each one's trace and lowering take 35-115 s whether or not
the persistent compile cache holds the executable (the cache skips only
XLA's compile; a traced query then runs in 0.08 s; the trace of the
integration and of the dadd formulas dominates at any h), and JAX's plan
builds 20 s more. `-m slow` runs them; tests/test_torch_sharded.py holds
the same port cases to the oracle without JAX. The all-reduce, the part
of those queries that only the sharded paths run, is held against JAX's
in the default tier.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import XyzzPoint as JXyzz
from msm_blst_tpu.msm import build_plan as jbuild_plan
from msm_blst_tpu.msm import fixed_point_list as jfixed_point_list
from msm_blst_tpu.msm import msm_bgmw_device as jmsm_bgmw_device
from msm_blst_tpu.msm import recode as jrecode
from msm_blst_tpu.parallel import ec_allreduce_xyzz as jec_allreduce_xyzz
from msm_blst_tpu.parallel import (make_points_mesh, make_windows_mesh,
                                   shard_plan_tables,
                                   shard_plan_tables_jmajor, sharded_msm_bgmw,
                                   sharded_msm_ches, sharded_msm_ches_windows)
from msm_blst_tpu.parallel.sharded import _shard_map
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.msm import params, recode
from msm_blst_tpu_torch.parallel import run_ranks
from msm_blst_tpu_torch.curves import G1, XyzzPoint
from msm_blst_tpu_torch.convert import fp_from_jax
from test_torch_sharded import (C6_SCALARS, CFG, CFG_J, N, PLANS, RANKS,
                                allreduce_rank, rank_cases, scalar_ints, want)

# case -> the JAX function it is held against
JAX_CASES = {"points_ches": "ches", "points_bgmw": "bgmw",
             "windows_ches": "ches_windows"}


def _jax_affine(jac) -> tuple:
    return tuple(JG1.affine_to_ints(JG1.jac_to_affine(jac))[0])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('rendezvous')}/store"
    names = sorted(JAX_CASES) + ["c6_points_bgmw"]
    return run_ranks(rank_cases, RANKS, "cpu", (names, False),
                     init_method=init, timeout_s=300)


@pytest.fixture(scope="module")
def jax_points():
    """tests/test_sharded.py's plan: N = 32 at CFG on the 8-device points
    mesh."""
    mesh = make_points_mesh(8)
    plan = shard_plan_tables(jbuild_plan(JG1, jfixed_point_list(JG1, N), CFG),
                             mesh)
    return mesh, plan


def _scalars(name: str):
    from test_torch_sharded import CASES

    pname, _, seed, edge, dup = CASES[name]
    return jnp.asarray(recode.scalars_from_ints(
        scalar_ints(seed, PLANS[pname][2], edge, dup)))


@pytest.mark.slow
def test_points_ches_equals_jax(port, jax_points):
    mesh, plan = jax_points
    got = _jax_affine(sharded_msm_ches(plan, mesh)(_scalars("points_ches")))
    assert got == want("points_ches")
    assert [r["points_ches"][0] for r in port] == [got] * RANKS


@pytest.mark.slow
def test_points_bgmw_equals_jax(port, jax_points):
    mesh, plan = jax_points
    got = _jax_affine(sharded_msm_bgmw(plan, mesh)(_scalars("points_bgmw")))
    assert got == want("points_bgmw")
    assert [r["points_bgmw"][0] for r in port] == [got] * RANKS


@pytest.mark.slow
def test_windows_ches_equals_jax(port):
    mesh = make_windows_mesh(8)
    plan = jbuild_plan(JG1, jfixed_point_list(JG1, N), CFG_J, streamed=True,
                       stock=False)
    plan = shard_plan_tables_jmajor(plan, mesh)
    got = _jax_affine(sharded_msm_ches_windows(plan, mesh)(
        _scalars("windows_ches")))
    assert got == want("windows_ches")
    assert [r["windows_ches"][0] for r in port] == [got] * RANKS


B = 8  # lanes of each rank's batch


def _allreduce_inputs():
    """RANKS * B G1 xyzz lanes, rank r's the block [r*B, (r+1)*B), made on
    the JAX side: doubled points (ZZ != 1) but for lane 0, infinity on
    rank 2; lane 1 the same point on ranks 0 and 1 (round 1 doubles it);
    lane 2 a point on rank 0 and its negation on rank 1 (round 1 cancels
    it)."""
    rng = random.Random(61)
    gen = G1_REF.generator_jac()
    pts = []
    for _ in range(RANKS * B):
        x, y = G1_REF.to_affine(G1_REF.jac_mult(rng.randrange(1, 1 << 64),
                                                gen))
        pts.append((x.v, y.v))
    pts[B + 1] = pts[1]
    pts[B + 2] = pts[2]
    lane = jnp.arange(RANKS * B)
    aff = JG1.affine_from_ints(pts)
    acc = jax.jit(JG1.xyzz_double)(JG1.xyzz_from_affine(aff))
    acc = JG1.select(lane == B + 2, JG1.xyzz_from_affine(aff, negate=lane >= 0),
                     acc)
    acc = JG1.select(lane == 2, JG1.xyzz_from_affine(aff), acc)
    acc = JG1.select(lane == 2 * B, JG1.xyzz_inf((RANKS * B,)), acc)
    return tuple(np.asarray(c) for c in acc)


def test_ec_allreduce_xyzz_matches_jax(tmp_path):
    acc = _allreduce_inputs()
    spec = P(None, "points")
    fn = jax.jit(_shard_map(
        lambda *c: tuple(jec_allreduce_xyzz(JG1, JXyzz(*c), "points")),
        make_points_mesh(RANKS), (spec,) * 4, (spec,) * 4))
    expect = [np.asarray(c) for c in fn(*acc)]

    def block(arrs, r):
        return [a[:, r * B:(r + 1) * B] for a in arrs]

    got = run_ranks(allreduce_rank, RANKS, "cpu",
                    ([block(acc, r) for r in range(RANKS)],),
                    init_method=f"file://{tmp_path}/store", timeout_s=300)
    for r in range(RANKS):
        assert all(np.array_equal(g, e)
                   for g, e in zip(got[r], block(expect, r)))
    # every rank holds, lane by lane, the sum of the four ranks' points
    def affine(arrs):
        return G1.affine_to_ints(G1.xyzz_to_affine(XyzzPoint(
            *(fp_from_jax(c, "cpu") for c in arrs))))

    inputs = affine(acc)
    for r in range(RANKS):
        out = affine(got[r])
        for lane in range(B):
            total = G1_REF.jac_inf()
            for k in range(RANKS):
                x, y = inputs[k * B + lane]
                total = G1_REF.jac_add(total, G1_REF.from_affine(
                    (G1_REF.F(x), G1_REF.F(y))))
            x, y = G1_REF.to_affine(total)
            assert out[lane] == (x.v, y.v)


@pytest.mark.parametrize("c, h, seed", [(8, 32, 51), (19, 14, 52),
                                        (16, 16, 53)])
def test_ches_recode_device_matches_jax(c, h, seed):
    ah = {8: CFG.ah, 19: params.CONFIGS[16].ah, 16: params.CONFIGS[14].ah}[c]
    ints = scalar_ints(seed, 64, [0, 1, R_ORDER - 1, R_ORDER, R_ORDER + 5,
                                  (1 << 255) - 1, 2 ** 254, 5, 5])
    sc = recode.scalars_from_ints(ints)
    m_t, b_t, a_t, _ = params.digit_conversion_table(1 << c, ah)
    got = recode.ches_recode_device(
        recode.to_device(sc, "cpu"), c, h,
        tuple(torch.as_tensor(t) for t in (m_t, b_t, a_t)))
    expect = jrecode.ches_recode_device(
        jnp.asarray(sc), c, h, tuple(jnp.asarray(t) for t in (m_t, b_t, a_t)))
    for g, e in zip(got, expect):
        e = np.array(e)
        assert g.numpy().dtype == e.dtype
        assert np.array_equal(g.numpy(), e)


@pytest.mark.slow
def test_c6_jax_points_bgmw_skips_the_reduction(port):
    """JAX's points-sharded BGMW differs from the oracle where the
    single-device query and the port's sharded query equal it."""
    _, cfg, n, _ = PLANS["g1_c6"]
    assert cfg.c_bgmw * cfg.h_bgmw <= 255 and n == len(C6_SCALARS)
    sc = jnp.asarray(recode.scalars_from_ints(C6_SCALARS))
    mesh = make_points_mesh(2)
    plan = jbuild_plan(JG1, jfixed_point_list(JG1, n), cfg)
    oracle = want("c6_points_bgmw")
    assert _jax_affine(jmsm_bgmw_device(plan, sc)) == oracle
    sharded = sharded_msm_bgmw(shard_plan_tables(plan, mesh), mesh)
    assert _jax_affine(sharded(sc)) != oracle
    assert [r["c6_points_bgmw"][0] for r in port] == [oracle] * RANKS

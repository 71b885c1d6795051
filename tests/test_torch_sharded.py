"""The port's sharded MSM (msm_blst_tpu_torch/parallel) on four CPU ranks.

One spawn of 4 gloo ranks (parallel.run_ranks, a FileStore under pytest's
tmp_path) for the whole file: a module fixture runs every case inside the
ranks and brings back each rank's results, and the tests read them. The
shapes are tests/test_sharded.py's: N = 32 at make_config(5, c=8, h=32,
c_bgmw=8, h_bgmw=32); G2 at n = 16; windows at h = 33 (padded to 36 over
4 ranks). The four plans are built one a rank and broadcast.

Each case's point, on every rank, equals the oracle (sum_i s_i 2^(i+1)
mod r) * G, and the single-process engine query on the same plan, in
affine (each rank's Jacobian words may differ). Edge scalars: 0,
duplicates, r - 1 and values in [r, 2^255) (the recodes' domain), with
BGMW also at a fold config (c'h' = 255, the r - a fold: the C6 case of
the JAX package, whose points-sharded BGMW skips the reduction mod r
there; the port reduces first). Two cases accumulate their buckets with
the segmented strategy (bucket_impl="segmented"). Then D = 1 (one-rank
groups), the
3-rank group's "power of two" error, "j" plans refused by the points-axis
functions (and "i" plans by the window ones), unsharded plans and odd
meshes refused; ShardedQuery.stage_ms's stages; breakdown, _pad_table_windows and _window_block against
the JAX package's, word for word.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.curves import G1, G2
from msm_blst_tpu_torch.curves.ops import PackedRows32
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_bgmw_device, msm_ches_device, params,
                                    recode)
from msm_blst_tpu_torch.parallel import run_ranks, sharded

CPU = torch.device("cpu")  # the port's entry points default to the card
RANKS = 4
N = 32
CFG = params.make_config(5, c=8, h=32, c_bgmw=8, h_bgmw=32)
CFG_G2 = params.make_config(4, c=8, h=32, c_bgmw=8, h_bgmw=32)
CFG_J = params.make_config(5, c=8, h=33, c_bgmw=8, h_bgmw=33)
# BGMW at c'h' = 255: the r - a fold runs (C6's reproduction config)
CFG_FOLD = params.make_config(5, c=8, h=32, c_bgmw=5, h_bgmw=51)
EDGE = [R_ORDER + 5, (1 << 255) - 1, 3, R_ORDER, 7, 11, R_ORDER - 1, 2, 0, 1,
        R_ORDER - 1, 5, 5, (1 << 255) - R_ORDER]


def _oracle(curve_name: str, ints) -> tuple:
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints))
    return refimpl.CURVES[curve_name].mult(total % R_ORDER)


def affine(curve, jac) -> tuple:
    """The affine point of a Jacobian batch of 1, on the host's ints."""
    ref = refimpl.CURVES[curve.name]
    F = ref.F
    conv = curve.F.to_ints if curve.name == "G1" else curve.F.to_int_pairs
    X, Y, Z = (conv(c)[0] for c in jac)
    if Z == F.zero:
        return ref.INF
    zi = F.inv(Z)
    zi2 = F.mul(zi, zi)
    return F.mul(X, zi2), F.mul(Y, F.mul(zi2, zi))


def scalar_ints(seed: int, n: int = N, edge=None, dup=None) -> list:
    """Seeded scalars below r; `edge` written over the first lanes;
    `dup` = (i, j) sets lane i to lane j's value."""
    ints = recode.scalars_to_ints(recode.random_scalars(n, seed))
    if edge:
        ints[:len(edge)] = edge
    if dup:
        ints[dup[0]] = ints[dup[1]]
    return ints


# Each case: (plan, query kind, seed, edge, dup): tests/test_sharded.py's
# seeds; the cases JAX's functions are held to in test_torch_sharded_jax.py
# keep its scalars, the others and the edge_ cases carry EDGE.
CASES = {
    "points_ches": ("g1", "ches", 31, [0], (1, 2)),
    "points_bgmw": ("g1", "bgmw", 32, None, None),
    "mesh2d_ches": ("g1", "ches_2d", 33, EDGE, None),
    "windows_ches": ("g1_j", "ches_windows", 36, [0], (1, 2)),
    "windows_bgmw_aliased": ("g1_j", "bgmw_windows", 37, EDGE, None),
    "g2_points_ches": ("g2", "ches", 34, None, (0, 1)),
    "edge_points_ches": ("g1", "ches", 40, EDGE, None),
    "edge_points_bgmw_fold": ("g1_fold", "bgmw", 42, EDGE, None),
    "edge_windows_ches": ("g1_j", "ches_windows", 44, EDGE, None),
}

# cases whose buckets the segmented strategy accumulates (K5's twins)
SEGMENTED = {"windows_bgmw_aliased", "mesh2d_ches"}

PLANS = {  # name: (curve, config, n, build_plan's keywords)
    "g1": ("G1", CFG, N, {}),
    "g1_fold": ("G1", CFG_FOLD, N, {"ches": False}),
    "g1_j": ("G1", CFG_J, N, {"streamed": True}),
    "g2": ("G2", CFG_G2, 16, {"bgmw": False}),
    # C6's reproduction: 8 points at c'h' = 255 (test_torch_sharded_jax.py)
    "g1_c6": ("G1", params.make_config(3, c=8, h=32, c_bgmw=5, h_bgmw=51), 8,
              {"ches": False}),
}
C6_SCALARS = [R_ORDER + 5, (1 << 255) - 1, 3, R_ORDER, 7, 11, R_ORDER - 1, 2]
CASES_JAX = {"c6_points_bgmw": ("g1_c6", "bgmw", 0, C6_SCALARS, None)}


def _case(name: str):
    return CASES[name] if name in CASES else CASES_JAX[name]


def _plans(rank: int, world: int, names, edges: bool) -> dict:
    """The plans of the cases `names` (and, with `edges`, the edge checks'
    "g1" and "g1_j"), each built on one rank and broadcast to all."""
    import torch.distributed as dist

    wanted = {_case(name)[0] for name in names}
    if edges:
        wanted |= {"g1", "g1_j"}
    curves = {"G1": G1, "G2": G2}
    built = {}
    for k, name in enumerate(sorted(wanted)):  # this rank's, all at once
        if k % world == rank:
            cname, cfg, n, kw = PLANS[name]
            curve = curves[cname]
            plan = build_plan(curve, fixed_point_list(curve, n, device=CPU),
                              cfg, stock=False, **kw)
            built[name] = dataclasses.replace(plan, curve=None)
    out = {}
    for k, name in enumerate(sorted(wanted)):
        holder = [built.get(name)]
        dist.broadcast_object_list(holder, src=k % world)
        out[name] = dataclasses.replace(holder[0],
                                        curve=curves[PLANS[name][0]])
    return out


def _query(kind: str, plan, mesh_points, mesh_windows, mesh2d,
           impl: str = "prefix"):
    """The sharded query of `kind` on its shard of `plan`, its buckets by
    the strategy `impl`."""
    S = sharded
    if kind == "ches":
        return S.sharded_msm_ches(S.shard_plan_tables(plan, mesh_points),
                                  mesh_points, impl)
    if kind == "bgmw":
        return S.sharded_msm_bgmw(S.shard_plan_tables(plan, mesh_points),
                                  mesh_points, impl)
    if kind == "ches_2d":
        return S.sharded_msm_ches_2d(S.shard_plan_tables(plan, mesh2d), mesh2d,
                                     impl)
    local = S.shard_plan_tables_jmajor(plan, mesh_windows)
    if kind == "ches_windows":
        return S.sharded_msm_ches_windows(local, mesh_windows, impl)
    return S.sharded_msm_bgmw_windows(local, mesh_windows, impl)


def _single(kind: str, plan, scalars):
    """The single-process engine query of the same algorithm."""
    if kind.startswith("ches"):
        return msm_ches_device(plan, scalars)
    return msm_bgmw_device(plan, scalars)


def _raises(fn) -> str:
    """The error fn raises, as "Type: message" ("" when it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the error
        return f"{type(e).__name__}: {e}"
    return ""


def rank_cases(rank: int, world: int, dev, names, edges: bool = True) -> dict:
    """One rank's results: {case: (sharded point, engine point or None)}
    for the cases `names` (the engine's point of the k-th case on rank k %
    world); with `edges`, the one-rank groups' points, the edge checks'
    errors ("errors": {check: text}) and the rows a shard holds."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    plans = _plans(rank, world, names, edges)
    mp_ = sharded.make_points_mesh(world, "cpu")
    mw = sharded.make_windows_mesh(world, "cpu")
    m2 = sharded.make_2d_mesh(2, world // 2, "cpu")
    out = {}
    for k, name in enumerate(names):
        pname, kind, seed, edge, dup = _case(name)
        plan = plans[pname]
        n = PLANS[pname][2]
        ints = scalar_ints(seed, n, edge, dup)
        sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
        impl = "segmented" if name in SEGMENTED else "prefix"
        got = affine(plan.curve, _query(kind, plan, mp_, mw, m2, impl)(sc))
        # the engine's query of case k on rank k % world only
        want = (affine(plan.curve, _single(kind, plan, sc))
                if k % world == rank else None)
        out[name] = (got, want)
    if not edges:
        return out
    # D = 1: a one-rank mesh of each rank's own group
    one, _ = dist.new_subgroups(group_size=1)
    m1 = DeviceMesh.from_group(one, "cpu", mesh_dim_names=("points",))
    ints = scalar_ints(31, N, [0], (1, 2))
    sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
    for kind in ("ches", "bgmw"):
        out[f"d1_{kind}"] = (affine(G1, _query(kind, plans["g1"], m1, None,
                                               None)(sc)), None)
    m1w = DeviceMesh.from_group(one, "cpu", mesh_dim_names=("windows",))
    out["d1_windows_ches"] = (affine(G1, _query(
        "ches_windows", plans["g1_j"], None, m1w, None)(sc)), None)
    # errors
    S = sharded
    errors = {}
    three = dist.new_group([0, 1, 2])
    if rank < 3:
        errors["three_ranks"] = _raises(lambda: S.ec_allreduce_xyzz(
            G1, G1.xyzz_inf((8,), CPU), three))
    j, i = plans["g1_j"], plans["g1"]
    errors["j_shard_plan_tables"] = _raises(lambda: S.shard_plan_tables(j, mp_))
    errors["j_ches"] = _raises(lambda: S.sharded_msm_ches(j, mp_))
    errors["j_bgmw"] = _raises(lambda: S.sharded_msm_bgmw(j, mp_))
    errors["j_ches_2d"] = _raises(lambda: S.sharded_msm_ches_2d(j, m2))
    errors["i_shard_jmajor"] = _raises(lambda: S.shard_plan_tables_jmajor(i, mw))
    errors["i_ches_windows"] = _raises(lambda: S.sharded_msm_ches_windows(i, mw))
    errors["i_bgmw_windows"] = _raises(lambda: S.sharded_msm_bgmw_windows(i, mw))
    errors["unsharded"] = _raises(lambda: S.sharded_msm_ches(i, mp_)(sc))
    errors["mesh_size"] = _raises(lambda: S.make_points_mesh(world - 1, "cpu"))
    errors["no_packed"] = _raises(lambda: S.sharded_msm_ches(
        dataclasses.replace(S.shard_plan_tables(i, mp_), packed_table=None),
        mp_))
    errors["alias_radix"] = _raises(lambda: S.sharded_msm_bgmw_windows(
        dataclasses.replace(S.shard_plan_tables_jmajor(j, mw),
                            cfg=dataclasses.replace(CFG_J, h=32)), mw))
    out["errors"] = errors
    out["stages"] = _query("ches", i, mp_, mw, m2).stage_ms(sc)
    out["rows"] = {
        "points": S.shard_plan_tables(i, mp_).table3nh.XY.shape[0],
        "windows": S.shard_plan_tables_jmajor(j, mw).table3nh.XY.shape[0]}
    return out


def allreduce_rank(rank: int, world: int, dev, limbs) -> tuple:
    """ec_allreduce_xyzz over the whole group on this rank's G1 xyzz batch,
    limbs[rank] (the JAX package's 16-bit limbs, per coordinate); returns
    the result in the same limbs (test_torch_sharded_jax.py)."""
    import torch.distributed as dist

    from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
    from msm_blst_tpu_torch.curves import XyzzPoint

    pts = XyzzPoint(*(fp_from_jax(c, dev) for c in limbs[rank]))
    return tuple(fp_to_jax(c) for c in sharded.ec_allreduce_xyzz(
        G1, pts, dist.group.WORLD))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    init = f"file://{tmp_path_factory.mktemp('rendezvous')}/store"
    return run_ranks(rank_cases, RANKS, CPU, (sorted(CASES),),
                     init_method=init, timeout_s=300)


def want(name: str):
    """The oracle's point of case `name`."""
    pname, _, seed, edge, dup = _case(name)
    cname, _, n, _ = PLANS[pname]
    return _oracle(cname, scalar_ints(seed, n, edge, dup))


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_equals_the_oracle(ranks, name):
    assert [r[name][0] for r in ranks] == [want(name)] * RANKS


@pytest.mark.parametrize("name", sorted(CASES))
def test_equals_the_single_process_query(ranks, name):
    k = sorted(CASES).index(name)
    got, engine = ranks[k % RANKS][name]
    assert engine == want(name)
    assert got == engine


@pytest.mark.parametrize("name", ["d1_ches", "d1_bgmw", "d1_windows_ches"])
def test_one_rank_groups(ranks, name):
    want = _oracle("G1", scalar_ints(31, N, [0], (1, 2)))
    assert [r[name][0] for r in ranks] == [want] * RANKS


def test_fold_config_is_tight():
    """The fold case runs the r - a fold, and its edge scalars reach past
    r and up to 2^255 - 1."""
    assert CFG_FOLD.c_bgmw * CFG_FOLD.h_bgmw <= 255
    assert max(EDGE) == (1 << 255) - 1 and min(EDGE) == 0
    assert any(R_ORDER <= e < 1 << 255 for e in EDGE)


def test_three_rank_group_needs_a_power_of_two(ranks):
    for r in ranks[:3]:
        assert r["errors"]["three_ranks"].startswith("ValueError")
        assert "power of two" in r["errors"]["three_ranks"]
    assert "three_ranks" not in ranks[3]["errors"]


@pytest.mark.parametrize("check", ["j_shard_plan_tables", "j_ches", "j_bgmw",
                                   "j_ches_2d"])
def test_points_axis_rejects_j_layout(ranks, check):
    for r in ranks:
        assert r["errors"][check].startswith("ValueError")
        assert "i-major" in r["errors"][check]


@pytest.mark.parametrize("check", ["i_shard_jmajor", "i_ches_windows",
                                   "i_bgmw_windows"])
def test_windows_axis_rejects_i_layout(ranks, check):
    for r in ranks:
        assert r["errors"][check].startswith("ValueError")
        assert "j-major" in r["errors"][check]


@pytest.mark.parametrize("check, text", [
    ("unsharded", "was the plan sharded"), ("mesh_size", "needs 3 ranks"),
    ("no_packed", "packed digit table"),
    ("alias_radix", "stride-3 aliasing requires matching radixes")])
def test_refusals(ranks, check, text):
    for r in ranks:
        assert r["errors"][check].startswith("ValueError")
        assert text in r["errors"][check]


def test_stage_ms_times_each_stage(ranks):
    """The points-axis CHES query stage by stage: two rounds over 4 ranks,
    the all-reduce the sum of its exchanges and dadds."""
    for r in ranks:
        st = r["stages"]
        assert set(st) == set(sharded.STAGES) | {"rounds"}
        assert st["rounds"] == 2
        assert st["allreduce_ms"] == st["exchange_ms"] + st["dadd_ms"]
        assert all(st[k] > 0 for k in sharded.STAGES)


def test_each_rank_holds_its_rows(ranks):
    """Points: 3h rows a point of N/4 points; windows: 3N rows a window of
    ceil(33/4) = 9 windows."""
    for r in ranks:
        assert r["rows"] == {"points": 3 * CFG.h * N // RANKS,
                             "windows": 3 * N * 9}


# ---------------------------------------------------------------------------
# host pieces against the JAX package's
# ---------------------------------------------------------------------------


def test_breakdown_matches_jax():
    from msm_blst_tpu.parallel import breakdown as jax_breakdown

    for n in (1, 8, 32, 255, 256, 512, 2048, 1 << 16, 1 << 21):
        for D in (1, 2, 4, 8, 16):
            for h in (1, 2, 3, 12, 13, 14, 16, 32, 33):
                assert sharded.breakdown(n, D, h) == jax_breakdown(n, D, h)


def _rows(n_rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2 ** 31, 2 ** 31, size=(n_rows, 24), dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("h, h_pad", [(33, 36), (14, 16), (12, 12), (5, 8)])
def test_pad_table_windows_matches_jax(h, h_pad):
    import jax.numpy as jnp

    from msm_blst_tpu.curves.ops import PackedRows32 as JRows
    from msm_blst_tpu.parallel.sharded import _pad_table_windows as jax_pad

    rpw = 6
    xy = _rows(rpw * h, h)
    got = sharded._pad_table_windows(PackedRows32(torch.as_tensor(xy)), rpw,
                                     h, h_pad).XY.numpy()
    want = np.asarray(jax_pad(JRows(jnp.asarray(xy)), rpw, h, h_pad).XY)
    assert got.shape == (rpw * h_pad, 24)
    assert np.array_equal(got, want)
    # each rank's block (shard_plan_tables_jmajor) is its slice of the pad
    for D in (1, 2, 4):
        if h_pad % D:
            continue
        h_loc = h_pad // D
        for w in range(D):
            block = sharded._window_rows(torch.as_tensor(xy), rpw, h,
                                         w * h_loc, h_loc).numpy()
            assert np.array_equal(block, want[w * h_loc * rpw:
                                               (w + 1) * h_loc * rpw])


@pytest.mark.parametrize("h, D", [(33, 4), (14, 4), (15, 4), (12, 4), (5, 4),
                                  (33, 8), (16, 2)])
def test_window_block_matches_jax(h, D):
    import jax.numpy as jnp

    from msm_blst_tpu.parallel.sharded import _window_block as jax_block

    h_loc = -(-h // D)
    h_pad = h_loc * D
    rng = np.random.default_rng(h * D)
    keys = rng.integers(0, 1 << 20, size=(h, 16)).astype(np.int32)
    sign = rng.integers(0, 2, size=(h, 16)).astype(bool)
    for w in range(D):
        got = sharded._window_block(
            (torch.as_tensor(keys), torch.as_tensor(sign)), w * h_loc, h_loc,
            h, h_pad)
        want = jax_block((jnp.asarray(keys), jnp.asarray(sign)), w * h_loc,
                         h_loc, h, h_pad)
        for g, x in zip(got, want):
            x = np.array(x)
            assert g.dtype == torch.as_tensor(x).dtype
            assert np.array_equal(g.numpy(), x)

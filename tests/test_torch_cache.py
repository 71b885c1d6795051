"""The port's plan cache (msm/cache.py) on the CPU: its own round trips,
and the JAX package's cache files in both directions.

* save_plan then load_plan gives the same tables word for word, the same
  row layout and the same alias flag, for an "i" and a "j" plan, aliased
  (BGMW reading the 3nh table: bgmw_stride3 kept, the JAX package's fault
  C1 fixed) and not, and for a BGMW-only plan; the loaded aliased plan's
  BGMW and CHES queries equal the oracle. A miss returns None; a save in
  the other layout over a cached key raises; without `device` the plan
  goes to the card, and without a card load_plan raises.
* A cache written by JAX's save_plan for a plan that is not aliased (c = 8,
  h = 32; c' = 5, h' = 51) loads into the port: its tables and points
  equal JAX's word for word (the points converted from JAX's limbs), and
  its CHES, BGMW and stock queries equal the oracle. JAX's load_plan reads
  the port's cache back to the same arrays. (JAX's own queries are not
  traced here: one takes 40-100 s on a CPU; the same tables give the same
  sums.)
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.msm import cache as jcache
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import precompute as jprecompute
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.convert import fp_to_jax
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list, load_plan,
                                    msm_bgmw_device, msm_ches_device,
                                    msm_stock_pippenger, params, recode,
                                    save_plan)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
ALIASED = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)
TIGHT = dict(c=8, h=32, c_bgmw=5, h_bgmw=51)
TABLES = ("table3nh", "table_nh", "points_rows")


@pytest.fixture(scope="module")
def points():
    return fixed_point_list(G1, N, device=CPU)


def _ints():
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=81))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    return ints


def _oracle(ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    return refimpl.G1.mult(total)


def _affine(jac):
    return G1.affine_to_ints(G1.jac_to_affine(jac))[0]


@pytest.fixture(scope="module")
def tight_plan(points):
    """The "i" plan of CHES, its own BGMW table and stock."""
    return build_plan(G1, points, params.make_config(4, **TIGHT),
                      streamed=False)


def _same_plans(a, b):
    assert (a.layout, a.bgmw_stride3) == (b.layout, b.bgmw_stride3)
    for name in TABLES:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x.XY, y.XY), name
    if a.points is not None:
        assert all(torch.equal(x, y) for x, y in zip(a.points, b.points))
    if a.table3nh is not None:
        assert torch.equal(a.packed_table, b.packed_table)
        assert np.array_equal(a.bucket_gaps, b.bucket_gaps)


def _windows(cfg, h):
    """cfg cut to h windows: a cheap streamed table (the cache reads only
    the config's key fields)."""
    return dataclasses.replace(cfg, h=h, h_bgmw=h)


@pytest.mark.parametrize("streamed", [False, True], ids=["i", "j"])
@pytest.mark.parametrize("tables", ["aliased", "own_nh", "bgmw_only"])
def test_round_trip(points, tight_plan, tmp_path, streamed, tables):
    cfg = params.make_config(4, **(ALIASED if tables == "aliased" else TIGHT))
    if streamed:
        cfg = _windows(cfg, 2)
    if tables == "own_nh" and not streamed:
        plan = tight_plan
    else:
        plan = build_plan(G1, points, cfg, ches=tables != "bgmw_only",
                          streamed=streamed)
    assert plan.bgmw_stride3 == (tables == "aliased")
    save_plan(plan, str(tmp_path))
    loaded = load_plan(G1, cfg, N, str(tmp_path), device=CPU)
    _same_plans(plan, loaded)


def test_aliased_plan_queries_after_the_round_trip(points, tmp_path):
    cfg = params.make_config(4, **ALIASED)
    save_plan(build_plan(G1, points, cfg, stock=False), str(tmp_path))
    loaded = load_plan(G1, cfg, N, str(tmp_path), device=CPU)
    assert loaded.bgmw_stride3 and loaded.table_nh is None
    ints = _ints()
    sc = recode.to_device(recode.scalars_from_ints(ints), CPU)
    assert _affine(msm_bgmw_device(loaded, sc)) == _oracle(ints)
    assert _affine(msm_ches_device(loaded, sc)) == _oracle(ints)


def test_miss_and_layout_mismatch(points, tmp_path):
    cfg = params.make_config(4, **ALIASED)
    assert load_plan(G1, cfg, N, str(tmp_path), device=CPU) is None
    small = _windows(cfg, 2)
    save_plan(build_plan(G1, points, small, streamed=False, bgmw=False,
                         stock=False), str(tmp_path))
    with pytest.raises(ValueError, match="layout"):
        save_plan(build_plan(G1, points, small, streamed=True, bgmw=False,
                             stock=False), str(tmp_path))
    assert load_plan(G1, cfg, N + 1, str(tmp_path), device=CPU) is None


def test_load_plan_defaults_to_the_card(points, tmp_path, monkeypatch):
    cfg = _windows(params.make_config(4, **ALIASED), 2)
    save_plan(build_plan(G1, points, cfg, streamed=True, bgmw=False,
                         stock=False), str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_plan(G1, cfg, N, str(tmp_path))


@pytest.fixture(scope="module")
def jax_cache(points, tmp_path_factory):
    """JAX's plan (3nh, its own nh, points) on the port's points, saved by
    JAX's save_plan."""
    d = str(tmp_path_factory.mktemp("jax_cache"))
    jplan = jprecompute.build_plan(
        JG1, JAffine(*(jnp.asarray(fp_to_jax(c)) for c in points)),
        jparams.make_config(4, **TIGHT))
    assert jplan.layout == "i" and not jplan.bgmw_stride3
    jcache.save_plan(jplan, d)
    return d, jplan


def test_jax_cache_loads_into_the_port(points, jax_cache):
    d, jplan = jax_cache
    cfg = params.make_config(4, **TIGHT)
    plan = load_plan(G1, cfg, N, d, device=CPU)
    assert plan.layout == "i" and not plan.bgmw_stride3
    for name in ("table3nh", "table_nh"):
        want = np.asarray(getattr(jplan, name).XY).view(np.int32)
        assert np.array_equal(getattr(plan, name).XY.numpy(), want), name
    assert all(torch.equal(x, y) for x, y in zip(plan.points, points))
    ints = _ints()
    host = recode.scalars_from_ints(ints)
    sc = recode.to_device(host, CPU)
    assert _affine(msm_ches_device(plan, sc)) == _oracle(ints)
    assert _affine(msm_bgmw_device(plan, sc)) == _oracle(ints)
    small = [s % (1 << 31) for s in ints]
    jac = msm_stock_pippenger(plan, recode.to_device(
        recode.scalars_from_ints(small), CPU), window=8, nbits=31)
    assert _affine(jac) == _oracle(small)


def test_port_cache_loads_into_jax(points, tight_plan, tmp_path):
    plan = tight_plan
    base = save_plan(plan, str(tmp_path))
    with open(base + "_meta.json") as f:
        assert json.load(f) == {"layout": "i", "bgmw_stride3": False}
    assert os.path.basename(base) == jcache._key(JG1, jparams.make_config(
        4, **TIGHT), N)
    jplan = jcache.load_plan(JG1, jparams.make_config(4, **TIGHT), N,
                             str(tmp_path))
    for name in ("table3nh", "table_nh"):
        assert np.array_equal(np.asarray(getattr(jplan, name).XY).view(np.int32),
                              getattr(plan, name).XY.numpy()), name
    assert all(np.array_equal(np.asarray(j), fp_to_jax(p))
               for j, p in zip(jplan.points, points))

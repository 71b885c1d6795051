"""The noindexhash CHES query on the CPU: buckets keyed by their value
(q/2 + 2 of them) in place of their index in the bucket set (reference
multi_scalar.c:466-503; msm_blst_tpu/msm/engine.py:338-354).

* params.packed_digit_table_value equals the JAX package's word for word
  at the tiny config's (q, ah) and CONFIGS[16]'s; every key is a bucket
  value below q/2 + 2.
* recode.ches_recode_device_packed on the 1-D value table equals JAX's
  jitted one (edge scalars 0, 1, r - 1, r, 2^256 - 1 among them), and on
  the 1-D index table equals the pairs table's recode.
* msm_ches_device on a noindexhash plan equals the oracle (sum s_i
  2^(i+1) mod r) * G and the index-keyed query on G1 and G2, under both
  bucket strategies, on "i" and "j" plans (c = 8, h = 32, n = 16; the "j"
  rows are the "i" rows permuted, the streamed builder's order, which
  tests/test_torch_bign.py holds). msm_bign and msm_ches_host_recode on
  such a plan read the index-keyed table and equal the oracle too.
* A save_plan / load_plan round trip carries packed_table_value (rebuilt
  from the config), and the loaded plan's noindexhash query equals the
  oracle. convert.plan_from_jax carries the JAX plan's noindexhash flag
  and value table. (The JAX query itself on that plan is traced in
  tests/test_torch_noindexhash_jax.py, `slow`: its trace takes 70-80 s.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import recode as jrecode
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.convert import plan_from_jax
from msm_blst_tpu_torch.curves import G1, G2, PackedRows32
from msm_blst_tpu_torch.msm import (build_plan, engine, fixed_point_list,
                                    load_plan, msm_bign, msm_ches_device,
                                    msm_ches_host_recode, params, recode,
                                    save_plan)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
CFG = params.make_config(4, c=8, h=32, c_bgmw=8, h_bgmw=32)


def _ints(seed=91):
    """Scalars with 0, r - 1 and a repeated scalar."""
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    return ints


def _scalars(ints):
    return recode.to_device(recode.scalars_from_ints(ints), CPU)


def _oracle(curve, ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    return refimpl.CURVES[curve.name].mult(total)


def _affine(plan, jac):
    return plan.curve.affine_to_ints(plan.curve.jac_to_affine(jac))[0]


def _j_plan(plan):
    """The plan with its 3nh rows permuted into the window-major "j"
    layout (row 3*(j*n+i)+m-1 holds the "i" row 3*(i*h+j)+m-1)."""
    h = plan.cfg.h
    i_, j_, m1 = np.meshgrid(np.arange(N), np.arange(h), np.arange(3),
                             indexing="ij")
    si = engine.ches_slots(i_, j_, m1, h, N, "i").reshape(-1)
    sj = engine.ches_slots(i_, j_, m1, h, N, "j").reshape(-1)
    rows = torch.empty_like(plan.table3nh.XY)
    rows[torch.as_tensor(sj)] = plan.table3nh.XY[torch.as_tensor(si)]
    return dataclasses.replace(plan, table3nh=PackedRows32(rows), layout="j")


@pytest.fixture(scope="module")
def plans():
    """{(curve name, layout): CHES plan}, index-keyed (noindexhash False)."""
    out = {}
    for curve in (G1, G2):
        plan = build_plan(curve, fixed_point_list(curve, N, device=CPU), CFG,
                          bgmw=False, stock=False, streamed=False)
        out[curve.name, "i"] = plan
        out[curve.name, "j"] = _j_plan(plan)
    return out


@pytest.mark.parametrize("cfg", [CFG, params.CONFIGS[16]],
                         ids=["tiny", "CONFIGS16"])
def test_value_table_matches_jax(cfg):
    got = params.packed_digit_table_value(cfg.q, cfg.ah)
    want = jparams.packed_digit_table_value(cfg.q, cfg.ah)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert got.shape == (cfg.q + 1,)
    assert int((got & 0xFFFFFF).max()) < (cfg.q >> 1) + 2


def _recode_scalars():
    ints = _ints(93)
    ints[:5] = [0, 1, R_ORDER - 1, R_ORDER, (1 << 256) - 1]
    return recode.scalars_from_ints(ints)


def test_value_recode_matches_jax():
    sc = _recode_scalars()
    table = params.packed_digit_table_value(CFG.q, CFG.ah)
    got = recode.ches_recode_device_packed(recode.to_device(sc, CPU), CFG.c,
                                           CFG.h, torch.as_tensor(table))
    want = jax.jit(lambda s, t: jrecode.ches_recode_device_packed(
        s, CFG.c, CFG.h, t))(jnp.asarray(sc), jnp.asarray(table))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_one_dim_index_table_matches_pairs():
    sc = recode.to_device(_recode_scalars(), CPU)
    flat = torch.as_tensor(params.packed_digit_table(CFG.q, CFG.ah))
    pairs = torch.as_tensor(params.packed_digit_table_pairs(CFG.q, CFG.ah))
    got = recode.ches_recode_device_packed(sc, CFG.c, CFG.h, flat)
    want = recode.ches_recode_device_packed(sc, CFG.c, CFG.h, pairs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("layout", ["i", "j"])
@pytest.mark.parametrize("impl", ["prefix", "segmented"])
@pytest.mark.parametrize("name", ["G1", "G2"])
def test_noindexhash_query(plans, name, impl, layout):
    plan = plans[name, layout]
    nih = dataclasses.replace(plan, noindexhash=True)
    ints = _ints()
    sc = _scalars(ints)
    got = _affine(nih, msm_ches_device(nih, sc, bucket_impl=impl))
    want = _affine(plan, msm_ches_device(plan, sc, bucket_impl=impl))
    assert got == want == _oracle(plan.curve, ints)


@pytest.mark.parametrize("layout", ["i", "j"])
def test_bign_and_host_recode_on_noindexhash_plan(plans, layout):
    nih = dataclasses.replace(plans["G1", layout], noindexhash=True)
    ints = _ints(95)
    want = _oracle(G1, ints)
    assert _affine(nih, msm_bign(nih, _scalars(ints), "ches", n_chunks=3)) == want
    assert _affine(nih, msm_ches_host_recode(
        nih, recode.scalars_from_ints(ints))) == want


def test_missing_value_table_raises(plans):
    nih = dataclasses.replace(plans["G1", "i"], noindexhash=True,
                              packed_table_value=None)
    with pytest.raises(ValueError, match="digit tables"):
        msm_ches_device(nih, _scalars(_ints()))


def test_cache_round_trip_carries_value_table(plans, tmp_path):
    plan = plans["G1", "i"]
    save_plan(plan, str(tmp_path))
    loaded = load_plan(G1, CFG, N, str(tmp_path), device=CPU)
    assert torch.equal(loaded.packed_table_value, plan.packed_table_value)
    nih = dataclasses.replace(loaded, noindexhash=True)
    ints = _ints(97)
    assert _affine(nih, msm_ches_device(nih, _scalars(ints))) == _oracle(G1, ints)


def test_plan_from_jax_carries_noindexhash(plans):
    """A JAX noindexhash plan's arrays (its tables are the port's bits, and
    its digit tables JAX's params) carried over by plan_from_jax."""
    plan = plans["G1", "j"]
    arrays = {"table3nh": plan.table3nh.XY.numpy().view(np.uint32),
              "packed_table": jparams.packed_digit_table_pairs(CFG.q, CFG.ah),
              "packed_table_value": jparams.packed_digit_table_value(
                  CFG.q, CFG.ah),
              "bucket_gaps": np.diff(CFG.bucket_set()).astype(np.int32),
              "noindexhash": True, "layout": "j"}
    got = plan_from_jax(arrays, CFG, device=CPU)
    assert got.noindexhash and got.layout == "j"
    assert torch.equal(got.packed_table_value, plan.packed_table_value)
    ints = _ints(99)
    assert _affine(got, msm_ches_device(got, _scalars(ints))) == _oracle(G1, ints)

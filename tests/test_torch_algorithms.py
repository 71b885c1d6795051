"""The port's BGMW95 and host-recode CHES queries, and the parts they add,
against the JAX package and the pure-integer oracle (stock Pippenger:
tests/test_torch_stock.py and tests/test_torch_stock_jax.py; the weighted
integration: tests/test_torch_scan.py).

* Host recode (reduce_mod_r_host, qary_digits_host, ches_recode_host) and
  the device BGMW/stock recode (fold_r_minus_a_device, signed_digits_device)
  equal JAX's word for word, edge scalars included (2^256 - 1 has its top
  word's sign bit set, the unsigned-compare hazard).
* build_bgmw_table equals JAX's nh table word for word on a config that is
  not aliased (c'=5, h'=51); build_plan aliases the nh table into the 3nh
  table exactly when the radixes match, in the streamed builders' "j"
  layout too; plan_from_jax converts a JAX BGMW/stock plan.
* msm_bgmw_device (aliased c=8, h=32 and the tight c'=5, h'=51 that runs the
  r - a fold) and msm_ches_host_recode, each with both bucket strategies, on
  scalars 0, r-1 and a repeated scalar: the affine result equals the oracle,
  and BGMW's equals JAX's msm_bgmw_device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import precompute as jprecompute
from msm_blst_tpu.msm import recode as jrecode
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax, plan_from_jax
from msm_blst_tpu_torch.curves import G1, JacPoint
from msm_blst_tpu_torch.msm import (build_bgmw_table, build_plan,
                                    fixed_point_list, msm_bgmw_device,
                                    msm_ches_host_recode, msm_stock_pippenger,
                                    params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
ALIASED = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)
TIGHT = dict(c=8, h=32, c_bgmw=5, h_bgmw=51)  # c'h' = 255: the r - a fold
EDGES = [0, 1, R_ORDER - 1, R_ORDER, R_ORDER + 1, (1 << 255) - 1,
         (1 << 254) - 1, 1 << 254, (1 << 254) + 1, (1 << 256) - 1]
IMPLS = ("prefix", "segmented")


def _edge_scalars():
    return recode.scalars_from_ints(
        recode.scalars_to_ints(recode.random_scalars(40, seed=5)) + EDGES)


def _query_ints():
    """test_e2e_fast.py's scalars: 0, r-1 and a repeated scalar."""
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=51))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    return ints


def _oracle(ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    return (x.v, y.v)


def _affine(jac):
    return G1.affine_to_ints(G1.jac_to_affine(jac))[0]


@pytest.fixture(scope="module")
def points():
    return fixed_point_list(G1, N, device=CPU)


@pytest.fixture(scope="module")
def plans(points):
    return {"aliased": build_plan(G1, points, params.make_config(4, **ALIASED)),
            "tight": build_plan(G1, points, params.make_config(4, **TIGHT),
                                ches=False, stock=False)}


@pytest.fixture(scope="module")
def jax_plan(points):
    """JAX's BGMW/stock plan on the same points, at the tight config."""
    jpts = JAffine(*(jnp.asarray(fp_to_jax(c)) for c in points))
    return jprecompute.build_plan(JG1, jpts, jparams.make_config(4, **TIGHT),
                                  ches=False)


@pytest.mark.parametrize("cfg", [ALIASED, TIGHT, "n16"])
def test_host_recode_matches_jax(cfg):
    cfg = (params.CONFIGS[16] if cfg == "n16" else params.make_config(4, **cfg))
    sc = _edge_scalars()
    red = recode.reduce_mod_r_host(sc)
    assert np.array_equal(red, jrecode.reduce_mod_r_host(sc))
    for c, h in ((cfg.c, cfg.h), (cfg.c_bgmw, cfg.h_bgmw)):
        assert np.array_equal(recode.qary_digits_host(red, c, h),
                              jrecode.qary_digits_host(red, c, h))
    small = sc[:, :-1]  # ches_recode_host takes scalars below 2^255
    for got, want in zip(recode.ches_recode_host(small, cfg.c, cfg.h, cfg.ah),
                         jrecode.ches_recode_host(small, cfg.c, cfg.h, cfg.ah,
                                                  use_native=False)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("c,h", [(5, 51), (17, 15), (8, 32), (13, 20), (2, 128)])
def test_device_signed_recode_matches_jax(c, h):
    sc = _edge_scalars()
    t = recode.to_device(sc, CPU)
    folded, flip = recode.fold_r_minus_a_device(t)
    jf, jflip = jax.jit(jrecode.fold_r_minus_a_device)(jnp.asarray(sc))
    assert np.array_equal(folded.numpy().view(np.uint32), np.asarray(jf))
    assert np.array_equal(flip.numpy(), np.asarray(jflip))
    assert flip.any() and not flip.all()
    absd, sign = recode.signed_digits_device(t, c, h)
    ja, js = jax.jit(lambda s: jrecode.signed_digits_device(s, c, h))(
        jnp.asarray(sc))
    assert np.array_equal(absd.numpy(), np.asarray(ja))
    assert np.array_equal(sign.numpy(), np.asarray(js))
    assert sign.any()


def test_bgmw_table_matches_jax(points, plans, jax_plan):
    cfg = params.make_config(4, **TIGHT)
    want = torch.as_tensor(np.array(jax_plan.table_nh.XY).view(np.int32))
    assert torch.equal(G1.to_rows32(build_bgmw_table(G1, points, cfg)).XY, want)
    tight = plans["tight"]
    assert not tight.bgmw_stride3 and torch.equal(tight.table_nh.XY, want)


def test_build_plan_aliases_bgmw_when_the_radixes_match(points, plans):
    aliased = plans["aliased"]
    assert aliased.bgmw_stride3 and aliased.table_nh is None
    assert aliased.table3nh is not None and aliased.points_rows is not None
    # a BGMW-only plan builds the nh table: the m=1 rows of the 3nh table
    own = build_plan(G1, points, params.make_config(4, **ALIASED), ches=False,
                     stock=False)
    assert not own.bgmw_stride3 and own.table3nh is None
    assert torch.equal(own.table_nh.XY, aliased.table3nh.XY[0::3])
    # the streamed builders ("j" layout) alias the same way (two windows)
    small = dataclasses.replace(params.make_config(4, **ALIASED), h=2,
                                h_bgmw=2)
    both = build_plan(G1, points, small, stock=False, streamed=True)
    nh = build_plan(G1, points, small, ches=False, stock=False, streamed=True)
    assert both.layout == nh.layout == "j"
    assert both.bgmw_stride3 and both.table_nh is None
    assert not nh.bgmw_stride3 and nh.table3nh is None
    assert torch.equal(nh.table_nh.XY, both.table3nh.XY[0::3])


def test_plan_from_jax_bgmw_and_stock(points, jax_plan):
    plan = plan_from_jax({"table_nh": np.asarray(jax_plan.table_nh.XY),
                          "bgmw_stride3": jax_plan.bgmw_stride3,
                          "points": tuple(np.asarray(c) for c in jax_plan.points)},
                         params.make_config(4, **TIGHT), device=CPU)
    assert plan.table3nh is None and not plan.bgmw_stride3
    assert all(torch.equal(a, b) for a, b in zip(plan.points, points))
    ints = _query_ints()
    jac = msm_bgmw_device(plan, recode.to_device(
        recode.scalars_from_ints(ints), CPU))
    assert _affine(jac) == _oracle(ints)
    # stock on scalars below 2^31: four windows of 8 bits
    small = [s % (1 << 31) for s in ints]
    jac = msm_stock_pippenger(plan, recode.to_device(
        recode.scalars_from_ints(small), CPU), window=8, nbits=31)
    assert _affine(jac) == _oracle(small)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cfg", ["aliased", "tight"])
def test_msm_bgmw_device_matches_oracle(plans, cfg, impl):
    ints = _query_ints()
    jac = msm_bgmw_device(plans[cfg], recode.to_device(
        recode.scalars_from_ints(ints), CPU), bucket_impl=impl)
    assert _affine(jac) == _oracle(ints)


def test_msm_bgmw_device_matches_jax(plans, jax_plan):
    sc = recode.scalars_from_ints(_query_ints())
    want = jax.jit(lambda s: jengine.msm_bgmw_device(jax_plan, s))(
        jnp.asarray(sc))
    want = JacPoint(*(fp_from_jax(np.asarray(c), CPU) for c in want))
    got = msm_bgmw_device(plans["tight"], recode.to_device(sc, CPU))
    assert _affine(got) == _affine(want)


@pytest.mark.parametrize("impl", IMPLS)
def test_msm_ches_host_recode_matches_oracle(plans, impl):
    ints = _query_ints()
    sc = recode.scalars_from_ints(ints)
    assert _affine(msm_ches_host_recode(plans["aliased"], sc,
                                        bucket_impl=impl)) == _oracle(ints)
    # the strategy is the keyword's alone: an unknown one is refused
    with pytest.raises(ValueError, match="bucket_impl"):
        msm_ches_host_recode(plans["aliased"], sc, bucket_impl=impl + "x")


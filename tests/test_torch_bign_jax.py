"""The port's big-n query on a window-major ("j" layout) plan against the
JAX package's on the same plan: JAX's build_plan(streamed=True) (c = 8,
h = 32, n = 16; the BGMW table aliased into the 3nh one) carried over by
convert.plan_from_jax, the scalars 0, r - 1 and a repeated one.

* msm_bign, CHES and BGMW95, at 3 bucket-range chunks equals JAX's
  jit_msm_bign(plan, algo, n_chunks=3) and the oracle (sum s_i 2^(i+1)
  mod r) * G, in affine. JAX's big-n query runs its device recode and its
  "j" slots (_ches_streams, _bgmw_streams), so it holds the port's digit
  streams on this plan too. JAX's other queries are not run here: tracing
  one takes 40-100 s on a CPU (the port's run against the oracle on a "j"
  plan in tests/test_torch_bign.py).
* bucket_sums_prefix split by position into 3 parts equals JAX's with
  MSM_STREAM_CHUNKS=3, bucket by bucket in affine (the two pipelines
  associate the adds otherwise, so their xyzz words differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.curves.ops import PackedRows32 as JPackedRows32
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import precompute as jprecompute
from msm_blst_tpu.msm import prefix_pipeline as jpp
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax, plan_from_jax
from msm_blst_tpu_torch.curves import G1, XyzzPoint
from msm_blst_tpu_torch.msm import (engine, fixed_point_list, msm_bign,
                                    params, prefix_pipeline, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
CFG = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)


@pytest.fixture(scope="module")
def plans():
    """(JAX's streamed plan, the port's plan carried over from it)."""
    pts = fixed_point_list(G1, N, device=CPU)
    jplan = jprecompute.build_plan(
        JG1, JAffine(*(jnp.asarray(fp_to_jax(c)) for c in pts)),
        jparams.make_config(4, **CFG), streamed=True)
    assert jplan.layout == "j" and jplan.bgmw_stride3
    plan = plan_from_jax(
        {"table3nh": np.asarray(jplan.table3nh.XY),
         "packed_table": np.asarray(jplan.packed_table),
         "bucket_gaps": jplan.bucket_gaps,
         "bgmw_stride3": jplan.bgmw_stride3, "layout": jplan.layout},
        params.make_config(4, **CFG), device=CPU)
    assert plan.layout == "j" and plan.bgmw_stride3
    return jplan, plan


def _ints():
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=71))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    return ints


def _oracle(ints):
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    return refimpl.G1.mult(total)


def _affine(jac):
    return G1.affine_to_ints(G1.jac_to_affine(jac))[0]


def _jax_affine(jac):
    return _affine(type(jac)(*(fp_from_jax(np.asarray(c), CPU) for c in jac)))


@pytest.mark.parametrize("algo", ["ches", "bgmw"])
def test_msm_bign_matches_jax(plans, algo):
    jplan, plan = plans
    ints = _ints()
    host = recode.scalars_from_ints(ints)
    got = msm_bign(plan, recode.to_device(host, CPU), algo, n_chunks=3)
    want = jengine.jit_msm_bign(jplan, algo, n_chunks=3)(jnp.asarray(host))
    assert _affine(got) == _jax_affine(want) == _oracle(ints)


def test_position_chunks_match_jax(plans, monkeypatch):
    jplan, plan = plans
    sc = recode.to_device(recode.scalars_from_ints(_ints()), CPU)
    keys_s, slots_s, signs_s = engine._sort_stream(
        *engine._ches_streams(plan, sc))
    nb = plan.cfg.b_size
    got = prefix_pipeline.bucket_sums_prefix(G1, plan.table3nh, slots_s,
                                             signs_s, keys_s, nb, chunks=3)
    monkeypatch.setenv("MSM_STREAM_CHUNKS", "3")
    table = JPackedRows32(jplan.table3nh.XY)
    want = jax.jit(lambda sl, sg, ky: jpp.bucket_sums_prefix(
        JG1, table, sl, sg, ky, nb))(
        jnp.asarray(slots_s.numpy()), jnp.asarray(signs_s.numpy()),
        jnp.asarray(keys_s.numpy()))

    def affine(b):
        return G1.affine_to_ints(G1.jac_to_affine(G1.xyzz_to_jac(b)))

    assert affine(got) == affine(
        XyzzPoint(*(fp_from_jax(np.asarray(x), CPU) for x in want)))

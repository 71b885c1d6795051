"""The port's precompute against the JAX package's, and carry-over of a JAX
plan into the port (convert.plan_from_jax).

At the shape of tests/test_e2e_fast.py (n=16, c=8, h=32): the fixed points
and the whole 3nh PackedRows32 table are bit-identical to JAX's, and a port
plan made from the JAX plan's arrays computes the oracle's MSM.
"""

import jax
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.msm import build_plan as j_build_plan
from msm_blst_tpu.msm import fixed_point_list as j_fixed_point_list
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp_from_jax, plan_from_jax
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_ches_device, params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
SMALL = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)


@pytest.fixture(scope="module")
def jax_plan():
    cfg = jparams.make_config(4, **SMALL)
    points = j_fixed_point_list(JG1, N)
    plan = j_build_plan(JG1, points, cfg, bgmw=False, stock=False)
    jax.block_until_ready(plan.table3nh.XY)
    return points, plan


@pytest.fixture(scope="module")
def port_plan():
    points = fixed_point_list(G1, N, device=CPU)
    return points, build_plan(G1, points, params.make_config(4, **SMALL))


def test_fixed_points_match_jax(jax_plan, port_plan):
    for got, want in zip(port_plan[0], jax_plan[0]):
        assert torch.equal(got, fp_from_jax(np.asarray(want), CPU))


def test_build_plan_table_matches_jax(jax_plan, port_plan):
    jp, tp = jax_plan[1], port_plan[1]
    assert np.array_equal(tp.table3nh.XY.numpy().view(np.uint32),
                          np.asarray(jp.table3nh.XY))
    assert np.array_equal(tp.packed_table.numpy(), np.asarray(jp.packed_table))
    assert np.array_equal(tp.bucket_gaps, jp.bucket_gaps)


def test_plan_from_jax_computes_the_same_msm(jax_plan, port_plan):
    jp = jax_plan[1]
    plan = plan_from_jax({"table3nh": np.asarray(jp.table3nh.XY),
                          "packed_table": np.asarray(jp.packed_table),
                          "bucket_gaps": jp.bucket_gaps},
                         params.make_config(4, **SMALL), device=CPU)
    sc = recode.random_scalars(N, seed=7)
    ints = recode.scalars_to_ints(sc)
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    for p in (plan, port_plan[1]):
        jac = msm_ches_device(p, recode.to_device(sc, CPU))
        assert G1.affine_to_ints(G1.jac_to_affine(jac))[0] == (x.v, y.v)

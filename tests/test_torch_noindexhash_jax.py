"""The port's noindexhash CHES query against the JAX package's on one plan
(`slow`: JAX's trace of the query takes 70-80 s on a CPU).

A JAX MsmPlan with noindexhash=True is made from the port's "j" rows
(c = 8, h = 32, n = 16) and the JAX package's digit tables, carried over
by convert.plan_from_jax, and queried by both packages on the same
scalars (0, r - 1 and a repeated one among them): the affine results are
equal, and equal to the oracle. The cheaper checks of the variant, the
carriage of the plan's fields among them, are in
tests/test_torch_noindexhash.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import PackedRows32 as JPackedRows32
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.convert import fp_from_jax, plan_from_jax
from msm_blst_tpu_torch.curves import G1
from msm_blst_tpu_torch.msm import (build_ches_table_rows_streamed,
                                    fixed_point_list, msm_ches_device, params,
                                    recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
CFG = params.make_config(4, c=8, h=32, c_bgmw=8, h_bgmw=32)


@pytest.mark.slow
def test_noindexhash_query_matches_jax():
    rows = build_ches_table_rows_streamed(
        G1, fixed_point_list(G1, N, device=CPU), CFG).XY.numpy().view(np.uint32)
    jplan = jengine.MsmPlan(
        curve=JG1, cfg=jparams.make_config(4, c=8, h=32, c_bgmw=8, h_bgmw=32),
        table3nh=JPackedRows32(jnp.asarray(rows)),
        packed_table=jnp.asarray(jparams.packed_digit_table_pairs(CFG.q, CFG.ah)),
        packed_table_value=jnp.asarray(
            jparams.packed_digit_table_value(CFG.q, CFG.ah)),
        bucket_gaps=np.diff(CFG.bucket_set()).astype(np.int32),
        noindexhash=True, layout="j")
    plan = plan_from_jax(
        {"table3nh": np.asarray(jplan.table3nh.XY),
         "packed_table": np.asarray(jplan.packed_table),
         "packed_table_value": np.asarray(jplan.packed_table_value),
         "bucket_gaps": jplan.bucket_gaps, "noindexhash": jplan.noindexhash,
         "layout": jplan.layout}, CFG, device=CPU)
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=101))
    ints[0], ints[1], ints[2] = 0, R_ORDER - 1, ints[3]
    host = recode.scalars_from_ints(ints)
    got = msm_ches_device(plan, recode.to_device(host, CPU))
    want = jax.jit(lambda s: jengine.msm_ches_device(jplan, s))(
        jnp.asarray(host))
    want = type(want)(*(fp_from_jax(np.asarray(c), CPU) for c in want))
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    aff = [G1.affine_to_ints(G1.jac_to_affine(j))[0] for j in (got, want)]
    assert aff[0] == aff[1] == refimpl.G1.mult(total)

"""The port's G1 CHES queries (device and host recoding, both bucket
strategies) against JAX's msm_ches_device on the same inputs.

n=16, c=8, h=32 with tests/test_e2e_fast.py's scalars (0, r-1 and a
repeated scalar). The JAX plan holds the port's 3nh table, which
tests/test_torch_plan.py shows is bit-identical to JAX's own build, so the
two pipelines read the same table and the same scalars. The two sort the
digit stream differently inside a bucket and associate the scans
differently, so their Jacobian words differ; the results are compared in
affine, and against the pure-integer oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import PackedRows32 as JPackedRows32
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import msm_ches_device as j_msm_ches_device
from msm_blst_tpu.msm.engine import MsmPlan as JMsmPlan
from msm_blst_tpu.msm.precompute import _attach_ches_params
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp_from_jax
from msm_blst_tpu_torch.curves import G1, JacPoint
from msm_blst_tpu_torch.msm import (build_plan, msm_ches_device,
                                    msm_ches_host_recode, params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
SMALL = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)


@pytest.fixture(scope="module")
def case():
    """The port's plan, the scalars and JAX's affine result on them."""
    # the oracle's fixed points (test_torch_plan.py checks the port's own)
    points = G1.affine_from_ints([(x.v, y.v) for x, y in G1_REF.fixed_points(N)],
                                 device=CPU)
    plan = build_plan(G1, points, params.make_config(4, **SMALL))
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=51))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    sc = recode.scalars_from_ints(ints)

    jcfg = jparams.make_config(4, **SMALL)
    jplan = JMsmPlan(curve=JG1, cfg=jcfg)
    jplan.table3nh = JPackedRows32(
        jnp.asarray(plan.table3nh.XY.numpy().view(np.uint32)))
    _attach_ches_params(jplan, jcfg)
    # jitted as tests/test_e2e_fast.py does, so a warm compile cache serves both
    jjac = jax.jit(lambda s: j_msm_ches_device(jplan, s))(jnp.asarray(sc))
    want = G1.affine_to_ints(G1.jac_to_affine(
        JacPoint(*(fp_from_jax(np.asarray(c), CPU) for c in jjac))))[0]

    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    assert want == (x.v, y.v)
    return plan, sc, want


def _affine(jac):
    return G1.affine_to_ints(G1.jac_to_affine(jac))[0]


def test_msm_ches_device_matches_jax(case):
    plan, sc, want = case
    assert _affine(msm_ches_device(plan, recode.to_device(sc, CPU))) == want


@pytest.mark.parametrize("impl", ["prefix", "segmented"])
def test_msm_ches_host_recode_matches_jax(case, impl):
    plan, sc, want = case
    assert _affine(msm_ches_host_recode(plan, sc, bucket_impl=impl)) == want
    assert _affine(msm_ches_device(plan, recode.to_device(sc, CPU),
                                   bucket_impl=impl)) == want

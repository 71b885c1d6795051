"""The port under the SOS multiply (mul_impl="sos") against JAX and the
oracle, on CPU tensors, where every unfused product takes K6's plain
version and the point formulas the SOS field's plain twin.

* The G1 CHES query at n = 16 (c = 4, h = 64; tests/test_torch_e2e.py's
  kind of scalars: 0, r-1, a repeated scalar), fixed points and plan built
  under SOS: the query's affine result equals JAX's msm_ches_device on the
  plan's table, and the oracle. Compared in affine (the two pipelines sort
  and associate differently). JAX compiling its query is most of this
  file's time on the CPU: about 65 s alone with a cold JAX compile cache,
  40 s with a warm one.
* A G2 batch inversion under SOS equals JAX's FP2.batch_inv and the
  oracle's inverses, word for word (0 maps to 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msm_blst_tpu.constants import P, R_ORDER
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import PackedRows32 as JPackedRows32
from msm_blst_tpu.fields.fp2 import FP2 as JFP2
from msm_blst_tpu.msm import msm_ches_device as j_msm_ches_device
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm.engine import MsmPlan as JMsmPlan
from msm_blst_tpu.msm.precompute import _attach_ches_params
from msm_blst_tpu.refimpl import G1_REF
from msm_blst_tpu_torch.convert import fp2_from_jax, fp_from_jax
from msm_blst_tpu_torch.curves import G1, JacPoint, for_mul_impl
from msm_blst_tpu_torch.fields import fp2_for
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_ches_device, params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
SMALL = dict(c=4, h=64, c_bgmw=4, h_bgmw=64)


def test_ches_query_under_sos_matches_jax_and_oracle():
    cfg = params.make_config(4, **SMALL)
    plan = build_plan(G1, fixed_point_list(G1, N, device=CPU, mul_impl="sos"),
                      cfg, mul_impl="sos")
    assert plan.curve is for_mul_impl("sos")["G1"]
    assert plan.curve.F.mul_impl == "sos"

    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=52))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    sc = recode.scalars_from_ints(ints)
    got = plan.curve.affine_to_ints(plan.curve.jac_to_affine(
        msm_ches_device(plan, recode.to_device(sc, CPU))))[0]

    jcfg = jparams.make_config(4, **SMALL)
    jplan = JMsmPlan(curve=JG1, cfg=jcfg)
    jplan.table3nh = JPackedRows32(
        jnp.asarray(plan.table3nh.XY.numpy().view(np.uint32)))
    _attach_ches_params(jplan, jcfg)
    jjac = jax.jit(lambda s: j_msm_ches_device(jplan, s))(jnp.asarray(sc))
    want = G1.affine_to_ints(G1.jac_to_affine(
        JacPoint(*(fp_from_jax(np.asarray(c), CPU) for c in jjac))))[0]
    assert got == want

    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints)) % R_ORDER
    x, y = G1_REF.to_affine(G1_REF.jac_mult(total, G1_REF.generator_jac()))
    assert got == (x.v, y.v)


def test_g2_batch_inv_under_sos_matches_jax_and_oracle():
    F2 = fp2_for("sos")
    assert F2.mul_impl == "sos" and F2.base.mul_impl == "sos"
    rng = np.random.default_rng(53)
    pairs = [(0, 0), (1, 0), (0, P - 1), (P - 1, P - 1)] + [
        tuple(int.from_bytes(rng.bytes(48), "little") % P for _ in range(2))
        for _ in range(12)]
    ja = JFP2.from_int_pairs(pairs)
    want = np.asarray(jax.jit(JFP2.batch_inv)(ja))
    got = F2.batch_inv(fp2_from_jax(np.asarray(ja), CPU))
    assert torch.equal(got, fp2_from_jax(want, CPU))
    for (a0, a1), (g0, g1) in zip(pairs, F2.to_int_pairs(got)):
        norm = (a0 * a0 + a1 * a1) % P
        if norm == 0:
            assert (g0, g1) == (0, 0)
        else:
            ninv = pow(norm, -1, P)
            assert (g0, g1) == (a0 * ninv % P, -a1 * ninv % P)

"""The port's stock Pippenger against JAX's msm_stock_pippenger: window=8 at
n = 16 on scalars 0, r-1 and a repeated scalar, jitted as
tests/test_e2e_fast.py does, on the same points. The results agree in
affine (tests/test_torch_stock.py holds both against the oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msm_blst_tpu.constants import R_ORDER
from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu.msm import engine as jengine
from msm_blst_tpu.msm import params as jparams
from msm_blst_tpu.msm import precompute as jprecompute
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import G1, JacPoint
from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                    msm_stock_pippenger, params, recode)

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 16
CFG = dict(c=8, h=32, c_bgmw=8, h_bgmw=32)  # stock reads no table


def test_msm_stock_pippenger_matches_jax():
    ints = recode.scalars_to_ints(recode.random_scalars(N, seed=51))
    ints[0], ints[1] = 0, R_ORDER - 1
    ints[2] = ints[3]
    sc = recode.scalars_from_ints(ints)
    plan = build_plan(G1, fixed_point_list(G1, N, device=CPU),
                      params.make_config(4, **CFG), ches=False, bgmw=False)
    got = msm_stock_pippenger(plan, recode.to_device(sc, CPU), window=8)

    jpts = JAffine(*(jnp.asarray(fp_to_jax(c)) for c in plan.points))
    jplan = jprecompute.build_plan(JG1, jpts, jparams.make_config(4, **CFG),
                                   ches=False, bgmw=False)
    want = jax.jit(lambda s: jengine.msm_stock_pippenger(jplan, s, window=8))(
        jnp.asarray(sc))
    want = JacPoint(*(fp_from_jax(np.asarray(c), CPU) for c in want))
    assert (G1.affine_to_ints(G1.jac_to_affine(got))
            == G1.affine_to_ints(G1.jac_to_affine(want)))

"""The port's ladder_mult and msm_wbits on the CPU against the JAX
package's curves/mult.py (G1), each traced once by JAX.

* ladder_mult on four lanes with the edge lanes of its y recovery: k = 0,
  k = r - 1 (-P), P at infinity, and k = 2: the port's Jacobian words
  equal JAX's, and each lane's affine point the oracle's.
* msm_wbits (w = 4) on eight lanes with the scalars 0, 1 and r - 1 and the
  point at infinity in one lane equals JAX's words and the oracle's sum;
  with a prebuilt _multiples_table passed as `table` it gives the same
  words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves import mult as jmult
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import G1, AffinePoint, ladder_mult, msm_wbits
from msm_blst_tpu_torch.curves import mult
from msm_blst_tpu_torch.msm import fixed_point_list, recode

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

W = 4


def _to_jax(pts):
    return JAffine(*(jnp.asarray(fp_to_jax(c)) for c in pts))


def _from_jax(jac):
    return type(jac)(*(fp_from_jax(np.asarray(c), CPU) for c in jac))


def _same_words(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _with_inf(n, lane):
    """Fixed points P_i = 2^(i+1) G, lane `lane` the point at infinity."""
    p = fixed_point_list(G1, n, device=CPU)
    inf = torch.arange(n) == lane
    return AffinePoint(*(torch.where(inf, 0, c) for c in p))


def test_ladder_mult_matches_jax():
    pts = _with_inf(4, 2)
    ks = [0, R_ORDER - 1, 7, 2]
    sc = recode.scalars_from_ints(ks)
    got = ladder_mult(G1, recode.to_device(sc, CPU), pts)
    want = jax.jit(lambda s, p: jmult.ladder_mult(JG1, s, p))(
        jnp.asarray(sc), _to_jax(pts))
    _same_words(got, _from_jax(want))
    aff = G1.affine_to_ints(G1.jac_to_affine(got))
    ref = refimpl.G1
    fixed = [ref.mult(pow(2, i + 1, R_ORDER)) for i in range(4)]
    assert aff == [ref.INF, ref.mult(R_ORDER - 1, fixed[1]), ref.INF,
                   ref.mult(2, fixed[3])]


def test_msm_wbits_matches_jax():
    n, inf_lane = 8, 5
    pts = _with_inf(n, inf_lane)
    rng = np.random.default_rng(9)
    ks = [0, 1, R_ORDER - 1] + [
        int.from_bytes(rng.bytes(32), "little") % R_ORDER for _ in range(5)]
    sc = recode.scalars_from_ints(ks)
    got = msm_wbits(G1, recode.to_device(sc, CPU), pts, w=W)
    want = jax.jit(lambda s, p: jmult.msm_wbits(JG1, s, p, w=W))(
        jnp.asarray(sc), _to_jax(pts))
    _same_words(got, _from_jax(want))
    total = sum(k * pow(2, i + 1, R_ORDER) for i, k in enumerate(ks)
                if i != inf_lane) % R_ORDER
    assert G1.affine_to_ints(G1.jac_to_affine(got))[0] == refimpl.G1.mult(total)
    table = mult._multiples_table(G1, pts, 1 << (W - 1))
    _same_words(msm_wbits(G1, recode.to_device(sc, CPU), pts, w=W,
                          table=table), got)

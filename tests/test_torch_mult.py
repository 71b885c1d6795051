"""The port's curves/mult.py on the CPU against the JAX package's (G1):
point_mult, points_add and in_group_device, each traced once by JAX.

* point_mult (w = 4) on eight lanes with the scalars 0, 1, 2, r - 1 and
  r - 2 and the point at infinity in one lane: the port's Jacobian words
  equal JAX's, and every lane's affine point the oracle's.
* points_add over seven lanes (odd: the tree carries a lane) equals JAX's
  words and the oracle's sum.
* in_group_device (w = 4) on two subgroup points, a point of the curve
  outside the subgroup and the point at infinity equals JAX's mask
  (True, True, False, True).
* The pieces mult.py reads: mul8 (Fp, Fp2), the curves' b, `_b_const` in
  the port's words, jac_from_affine / jac_is_inf / affine_inf, and
  tree_reduce_xyzz at every lane count from 1 to 5 against a plain sum.

msm_wbits and ladder_mult: tests/test_torch_mult_ladder.py; G2 against the
oracle: tests/test_torch_mult_g2.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.curves import G1 as JG1
from msm_blst_tpu.curves import curve as jcurve
from msm_blst_tpu.curves import mult as jmult
from msm_blst_tpu.curves.ops import AffinePoint as JAffine
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import P, R_ORDER
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.curves import (G1, G2, AffinePoint, in_group_device,
                                       point_mult, points_add)
from msm_blst_tpu_torch.curves import mult
from msm_blst_tpu_torch.fields import FP, FP2
from msm_blst_tpu_torch.msm import fixed_point_list, recode

torch.set_num_threads(1)  # small tensors: threads add contention, not speed
CPU = torch.device("cpu")  # the port's entry points default to the card

N = 8
W = 4
INF_LANE = 7


def _fixed(n):
    """The oracle's fixed points P_i = 2^(i+1) G."""
    return [refimpl.G1.mult(pow(2, i + 1, R_ORDER)) for i in range(n)]


def _mult_full(k, pt):
    """k * pt without reducing k mod r (refimpl's mult reduces it)."""
    acc = refimpl.G1.INF
    for bit in bin(k)[2:]:
        acc = refimpl.G1.add(acc, acc)
        if bit == "1":
            acc = refimpl.G1.add(acc, pt)
    return acc


def _to_jax(pts):
    return JAffine(*(jnp.asarray(fp_to_jax(c)) for c in pts))


def _from_jax(jac):
    return type(jac)(*(fp_from_jax(np.asarray(c), CPU) for c in jac))


def _same_words(got, want):
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def pts():
    """Eight fixed points, lane INF_LANE replaced by the point at infinity."""
    p = fixed_point_list(G1, N, device=CPU)
    inf = torch.arange(N) == INF_LANE
    return AffinePoint(*(torch.where(inf, 0, c) for c in p))


def test_point_mult_matches_jax(pts):
    rng = np.random.default_rng(5)
    ks = [0, 1, 2, R_ORDER - 1, R_ORDER - 2] + [
        int.from_bytes(rng.bytes(32), "little") % R_ORDER for _ in range(3)]
    sc = recode.scalars_from_ints(ks)
    got = point_mult(G1, recode.to_device(sc, CPU), pts, w=W)
    want = jax.jit(lambda s, p: jmult.point_mult(JG1, s, p, w=W))(
        jnp.asarray(sc), _to_jax(pts))
    _same_words(got, _from_jax(want))
    aff = G1.affine_to_ints(G1.jac_to_affine(got))
    fixed = _fixed(N)
    for i, k in enumerate(ks):
        want_i = refimpl.G1.INF if i == INF_LANE else refimpl.G1.mult(k, fixed[i])
        assert aff[i] == want_i, f"lane {i}"


def test_points_add_matches_jax(pts):
    head = AffinePoint(*(c[:, :7] for c in pts))
    got = points_add(G1, head)
    want = jax.jit(lambda p: jmult.points_add(JG1, p))(_to_jax(head))
    _same_words(got, _from_jax(want))
    total = sum(pow(2, i + 1, R_ORDER) for i in range(7)) % R_ORDER
    assert G1.affine_to_ints(G1.jac_to_affine(got))[0] == refimpl.G1.mult(total)


def _outside_subgroup():
    """The first point (x, y) of y^2 = x^3 + 4 with x >= 2 that r does not
    kill (p = 3 mod 4: y = a^((p+1)/4) when a is a square)."""
    x = 1
    while True:
        x += 1
        a = (x * x * x + 4) % P
        y = pow(a, (P + 1) // 4, P)
        if y * y % P == a and _mult_full(R_ORDER, (x, y)) != refimpl.G1.INF:
            return x, y


def test_in_group_matches_jax(pts):
    bad = _outside_subgroup()
    good = G1.affine_to_ints(pts)[:2]
    dev = G1.affine_from_ints(good + [bad, (0, 0)], device=CPU)
    got = in_group_device(G1, dev, w=W)
    want = np.asarray(jax.jit(lambda p: jmult.in_group_device(JG1, p, w=W))(
        _to_jax(dev)))
    assert got.tolist() == want.tolist() == [True, True, False, True]


# ---- the pieces mult.py reads --------------------------------------------------


@pytest.mark.parametrize("v", [0, 1, 5, P - 1, P // 8 + 3])
def test_mul8_fp(v):
    a = FP.from_ints([v], device=CPU)
    assert FP.to_ints(FP.mul8(a)) == [8 * v % P]


def test_mul8_fp2():
    a = FP2.from_int_pairs([(3, P - 2), (P - 1, 7)], device=CPU)
    assert FP2.to_int_pairs(FP2.mul8(a)) == [(24, (-16) % P), ((-8) % P, 56)]


@pytest.mark.parametrize("curve, jax_curve", [(G1, jcurve.G1), (G2, jcurve.G2)],
                         ids=["G1", "G2"])
def test_b_const_in_port_words(curve, jax_curve):
    assert curve.b_int == jax_curve.b_int
    b = mult._b_const(curve, (3,), CPU)
    assert b.shape == curve.F.lead + (3,)
    ints = (curve.F.to_ints(b) if curve.name == "G1"
            else curve.F.to_int_pairs(b))
    assert ints == [curve.b_int] * 3


def test_jacobian_lifts():
    p = G1.affine_from_ints([refimpl.G1.GENERATOR, (0, 0)], device=CPU)
    jac = G1.jac_from_affine(p)
    assert G1.jac_is_inf(jac).tolist() == [False, True]
    assert G1.affine_to_ints(G1.jac_to_affine(jac)) == [
        refimpl.G1.GENERATOR, (0, 0)]
    inf = G1.affine_inf((2,), CPU)
    assert G1.affine_is_inf(inf).tolist() == [True, True]


@pytest.mark.parametrize("lanes", [1, 2, 3, 4, 5])
def test_tree_reduce_lanes(lanes):
    pts = fixed_point_list(G1, lanes, device=CPU)
    got = G1.tree_reduce_xyzz(G1.xyzz_from_affine(pts))
    assert got.X.shape[-1] == 1
    total = sum(pow(2, i + 1, R_ORDER) for i in range(lanes)) % R_ORDER
    aff = G1.affine_to_ints(G1.jac_to_affine(G1.xyzz_to_jac(got)))[0]
    assert aff == refimpl.G1.mult(total)

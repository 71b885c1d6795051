"""The port's copies of the JAX package's pure-Python oracles, held to the
originals on the same seeded inputs: the SSWU constants
(protocol/iso_constants.py), the refimpl element classes (Fp, Fr, Fp2),
CurveRef's Jacobian and xyzz formulas with every case of their analysis and
the naive MSM, and the Fp6 / Fp12 tower (products, inverse, Frobenius,
cyclotomic square). Values compare as ints; the port's refimpl package
keeps its int-only G1 / G2 beside the classes.
"""

import random

import pytest

from msm_blst_tpu.protocol import iso_constants as JK
from msm_blst_tpu.protocol import tower as jtower
from msm_blst_tpu.refimpl import curve as jcurve
from msm_blst_tpu.refimpl import field as jfield
from msm_blst_tpu_torch import refimpl
from msm_blst_tpu_torch.constants import P, R_ORDER
from msm_blst_tpu_torch.protocol import iso_constants as K
from msm_blst_tpu_torch.protocol import tower
from msm_blst_tpu_torch.refimpl import curve, field

rng = random.Random(0x5EED16)


def test_iso_constants_equal_jax():
    names = sorted(n for n in dir(JK) if n.isupper())
    assert names == sorted(n for n in dir(K) if n.isupper())
    assert len(names) == 14  # Z, A, B of G1 and G2, and the eight polynomials
    for n in names:
        assert getattr(K, n) == getattr(JK, n), n


def test_refimpl_package_keeps_the_int_oracle():
    assert refimpl.CURVES == {"G1": refimpl.G1, "G2": refimpl.G2}
    g = refimpl.G1.GENERATOR
    assert (refimpl.G1_REF.gen_affine[0].v, refimpl.G1_REF.gen_affine[1].v) == g
    assert refimpl.G1_REF is curve.G1_REF and refimpl.Fp is field.Fp


def _val(x):
    """An element of either package's refimpl as ints."""
    if hasattr(x, "c0"):
        return (x.c0.v, x.c1.v)
    return x.v


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_prime_field_classes(name):
    T, J = getattr(field, name), getattr(jfield, name)
    m = T.MODULUS
    assert m == J.MODULUS == (P if name == "Fp" else R_ORDER)
    vals = [0, 1, m - 1, m, m + 5] + [rng.randrange(m) for _ in range(4)]
    for a in vals:
        for b in vals[:6]:
            ta, tb, ja, jb = T(a), T(b), J(a), J(b)
            for op in ("__add__", "__sub__", "__mul__"):
                assert getattr(ta, op)(tb).v == getattr(ja, op)(jb).v
            assert (ta == tb) == (ja == jb)
        ta, ja = T(a), J(a)
        assert (-ta).v == (-ja).v and ta.sqr().v == ja.sqr().v
        assert ta.mul_small(7).v == ja.mul_small(7).v
        assert ta.is_zero() == ja.is_zero() and hash(ta) == hash(ja)
        assert repr(ta) == repr(ja)
        if a % m:
            assert ta.inv().v == ja.inv().v
        else:
            with pytest.raises(ZeroDivisionError):
                ta.inv()
    assert T.zero().v == 0 and T.one().v == 1


def test_fp2_class():
    vals = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + [
        (rng.randrange(P), rng.randrange(P)) for _ in range(5)]
    for a in vals:
        for b in vals[:5]:
            ta, tb = field.Fp2(*a), field.Fp2(*b)
            ja, jb = jfield.Fp2(*a), jfield.Fp2(*b)
            for op in ("__add__", "__sub__", "__mul__"):
                assert _val(getattr(ta, op)(tb)) == _val(getattr(ja, op)(jb))
            assert (ta == tb) == (ja == jb)
        ta, ja = field.Fp2(*a), jfield.Fp2(*a)
        assert _val(-ta) == _val(-ja) and _val(ta.sqr()) == _val(ja.sqr())
        assert _val(ta.mul_small(3)) == _val(ja.mul_small(3))
        assert hash(ta) == hash(ja) and repr(ta) == repr(ja)
        if a != (0, 0):
            assert _val(ta.inv()) == _val(ja.inv())
    assert _val(field.Fp2.one()) == (1, 0) and field.Fp2.zero().is_zero()


def _pt(p):
    return tuple(_val(c) for c in p)


def _curves():
    return [("G1", curve.G1_REF, jcurve.G1_REF),
            ("G2", curve.G2_REF, jcurve.G2_REF)]


@pytest.mark.parametrize("name, T, J", _curves(), ids=["G1", "G2"])
def test_curve_ref_formulas(name, T, J):
    """jac_* and xyzz_* on both curves, every case: general, doubling,
    cancelling, either operand at infinity, and the subtracting madd."""
    ks = [rng.randrange(1, R_ORDER) for _ in range(2)]
    pts_t = [T.affine_mult(k, T.gen_affine) for k in ks]
    pts_j = [J.affine_mult(k, J.gen_affine) for k in ks]
    assert [_pt(p) for p in pts_t] == [_pt(p) for p in pts_j]
    (a_t, b_t), (a_j, b_j) = pts_t, pts_j
    neg_t, neg_j = (a_t[0], -a_t[1]), (a_j[0], -a_j[1])
    pairs = [(a_t, b_t, a_j, b_j), (a_t, a_t, a_j, a_j),
             (a_t, neg_t, a_j, neg_j), (T.affine_inf(), a_t, J.affine_inf(),
                                        a_j), (a_t, T.affine_inf(), a_j,
                                               J.affine_inf())]
    for p_t, q_t, p_j, q_j in pairs:
        jt = T.jac_add(T.from_affine(p_t), T.jac_double(T.from_affine(q_t)))
        jj = J.jac_add(J.from_affine(p_j), J.jac_double(J.from_affine(q_j)))
        assert _pt(jt) == _pt(jj)
        assert _pt(T.to_affine(T.jac_add(T.from_affine(p_t),
                                         T.from_affine(q_t)))) == _pt(
            J.to_affine(J.jac_add(J.from_affine(p_j), J.from_affine(q_j))))
        xt, xj = T.xyzz_from_affine(p_t), J.xyzz_from_affine(p_j)
        for sub in (False, True):
            assert _pt(T.xyzz_dadd_affine(xt, q_t, subtract=sub)) == _pt(
                J.xyzz_dadd_affine(xj, q_j, subtract=sub))
        st = T.xyzz_dadd(xt, T.xyzz_from_affine(q_t))
        sj = J.xyzz_dadd(xj, J.xyzz_from_affine(q_j))
        assert _pt(st) == _pt(sj)
        assert _pt(T.xyzz_double(st)) == _pt(J.xyzz_double(sj))
        assert _pt(T.xyzz_to_affine(st)) == _pt(J.xyzz_to_affine(sj))
        assert _pt(T.xyzz_to_jacobian(st)) == _pt(J.xyzz_to_jacobian(sj))
        assert T.is_on_curve(T.xyzz_to_affine(st))
    assert _pt(T.xyzz_from_affine(a_t, negate=True)) == _pt(
        J.xyzz_from_affine(a_j, negate=True))
    assert T.jac_is_inf(T.jac_inf()) and T.xyzz_is_inf(T.xyzz_inf())


@pytest.mark.parametrize("name, T, J", _curves(), ids=["G1", "G2"])
def test_curve_ref_naive_msm_and_fixed_points(name, T, J):
    n = 3
    assert [_pt(p) for p in T.fixed_points(n)] == [_pt(p) for p in
                                                   J.fixed_points(n)]
    scalars = [0, R_ORDER - 1, rng.randrange(R_ORDER)]
    got = T.naive_msm(scalars, T.fixed_points(n))
    assert _pt(got) == _pt(J.naive_msm(scalars, J.fixed_points(n)))
    ints = refimpl.CURVES[name]
    want = ints.mult(sum(s * pow(2, i + 1, R_ORDER)
                         for i, s in enumerate(scalars)) % R_ORDER)
    assert _pt(got) == want


# ---- the tower ------------------------------------------------------------------


def _fp12_pair():
    """The same random Fp12 in the port's classes and JAX's."""
    vals = [(rng.randrange(P), rng.randrange(P)) for _ in range(6)]

    def build(fmod, tmod):
        c = [fmod.Fp2(*v) for v in vals]
        return tmod.Fp12(tmod.Fp6(*c[:3]), tmod.Fp6(*c[3:]))

    return build(field, tower), build(jfield, jtower)


def _v12(f):
    return tuple(_val(c) for a in (f.a0, f.a1) for c in (a.c0, a.c1, a.c2))


def test_tower_constants():
    assert _val(tower.XI) == _val(jtower.XI) == (1, 1)
    assert [_val(g) for g in tower._G] == [_val(g) for g in jtower._G]
    a = field.Fp2(5, 7)
    assert _val(tower._fp2_pow(a, 12345)) == _val(
        jtower._fp2_pow(jfield.Fp2(5, 7), 12345))
    assert _val(tower.fp2_conj(a)) == (5, P - 7)
    assert _val(tower.fp2_mul_by_xi(a)) == _val(
        jtower.fp2_mul_by_xi(jfield.Fp2(5, 7)))


def test_tower_fp6():
    vals = [(rng.randrange(P), rng.randrange(P)) for _ in range(6)]
    t = [tower.Fp6(*(field.Fp2(*v) for v in vals[i:i + 3])) for i in (0, 3)]
    j = [jtower.Fp6(*(jfield.Fp2(*v) for v in vals[i:i + 3])) for i in (0, 3)]

    def v6(f):
        return tuple(_val(c) for c in (f.c0, f.c1, f.c2))

    for op in ("__add__", "__sub__", "__mul__"):
        assert v6(getattr(t[0], op)(t[1])) == v6(getattr(j[0], op)(j[1]))
    for op in ("inv", "sqr", "mul_by_v", "__neg__"):
        assert v6(getattr(t[0], op)()) == v6(getattr(j[0], op)())
    assert v6(t[0].mul_fp2(field.Fp2(3, 4))) == v6(
        j[0].mul_fp2(jfield.Fp2(3, 4)))


def test_tower_fp12_products_inverse_frobenius():
    (a, ja), (b, jb) = _fp12_pair(), _fp12_pair()
    for op in ("__add__", "__sub__", "__mul__"):
        assert _v12(getattr(a, op)(b)) == _v12(getattr(ja, op)(jb))
    for op in ("inv", "sqr", "conj", "frobenius", "__neg__"):
        assert _v12(getattr(a, op)()) == _v12(getattr(ja, op)())
    assert _v12(a.frobenius_n(3)) == _v12(ja.frobenius_n(3))
    assert _v12(a.pow_int(-12345)) == _v12(ja.pow_int(-12345))
    assert a * a.inv() == tower.Fp12.one() and a.frobenius_n(12) == a
    assert tower.Fp12.one().is_one() and tower.Fp12.zero().is_zero()


def test_tower_cyclotomic_sqr():
    """On an element of the cyclotomic subgroup (the final exponentiation's
    easy part of a random element) the Granger-Scott square equals JAX's
    and the generic square."""
    a, ja = _fp12_pair()
    f = a.conj() * a.inv()
    f = f.frobenius_n(2) * f
    jf = ja.conj() * ja.inv()
    jf = jf.frobenius_n(2) * jf
    assert _v12(f.cyclotomic_sqr()) == _v12(jf.cyclotomic_sqr())
    assert f.cyclotomic_sqr() == f.sqr()

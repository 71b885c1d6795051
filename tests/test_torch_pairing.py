"""The port's copy of protocol/pairing.py against the JAX package's: the
Miller loop, the final exponentiation, the pairing, the multi-pairing and
pairing_check give the same Fp12 coefficients and bools on the same
seeded points (generators, random multiples, negations and infinity), and
the algebraic properties of the JAX package's own tests hold.
"""

import importlib
import random

from msm_blst_tpu.refimpl import G1_REF as JG1_REF
from msm_blst_tpu.refimpl import G2_REF as JG2_REF
from msm_blst_tpu.refimpl import field as jfield
from msm_blst_tpu_torch.constants import R_ORDER
from msm_blst_tpu_torch.protocol import Fp12
from msm_blst_tpu_torch.refimpl import G1_REF, G2_REF

# protocol/__init__ exports a function named pairing, which hides the module
jpr = importlib.import_module("msm_blst_tpu.protocol.pairing")
pr = importlib.import_module("msm_blst_tpu_torch.protocol.pairing")

rng = random.Random(0x9A12)


def _v12(f):
    """An Fp12 of either package as its six Fp2 coefficients, (c0, c1)
    int pairs."""
    return tuple((c.c0.v, c.c1.v) for a in (f.a0, f.a1)
                 for c in (a.c0, a.c1, a.c2))


def _j1(pt):
    return (jfield.Fp(pt[0].v), jfield.Fp(pt[1].v))


def _j2(pt):
    return tuple(jfield.Fp2(c.c0.v, c.c1.v) for c in pt)


def test_constants():
    assert pr.BLS_X == jpr.BLS_X and pr._HARD_EXP == jpr._HARD_EXP
    for name in ("_W", "_W_INV2", "_W_INV3"):
        assert _v12(getattr(pr, name)) == _v12(getattr(jpr, name))


def test_miller_loop_and_final_exp():
    g1, g2 = G1_REF.gen_affine, G2_REF.gen_affine
    f = pr.miller_loop(g1, g2)
    jf = jpr.miller_loop(JG1_REF.gen_affine, JG2_REF.gen_affine)
    assert _v12(f) == _v12(jf)
    e = pr.final_exp(f)
    assert _v12(e) == _v12(jpr.final_exp(jf))
    assert not e.is_one() and e.pow_int(R_ORDER) == Fp12.one()


def test_pairing_bilinearity():
    a, b = rng.randrange(1, R_ORDER), rng.randrange(1, R_ORDER)
    p = G1_REF.affine_mult(a, G1_REF.gen_affine)
    q = G2_REF.affine_mult(b, G2_REF.gen_affine)
    e = pr.pairing(p, q)
    assert _v12(e) == _v12(jpr.pairing(_j1(p), _j2(q)))
    g = pr.pairing(G1_REF.gen_affine, G2_REF.gen_affine)
    assert e == g.pow_int(a * b % R_ORDER)


def test_multi_pairing_and_check():
    g1, g2 = G1_REF.gen_affine, G2_REF.gen_affine
    neg_g1 = (g1[0], -g1[1])
    q7 = G2_REF.affine_mult(7, g2)
    for pairs in ([(g1, g2), (neg_g1, g2)], [(g1, q7), (neg_g1, g2)]):
        jpairs = [(_j1(p), _j2(q)) for p, q in pairs]
        m = pr.multi_pairing(pairs)
        assert _v12(m) == _v12(jpr.multi_pairing(jpairs))
        assert pr.pairing_check(pairs) == jpr.pairing_check(jpairs) == \
            m.is_one()
    assert pr.pairing_check([(g1, g2), (neg_g1, g2)])
    assert not pr.pairing_check([(g1, q7), (neg_g1, g2)])
    ml = pr.miller_loop_n([(g1, g2), (g1, q7)])
    assert _v12(ml) == _v12(jpr.miller_loop_n(
        [(_j1(g1), _j2(g2)), (_j1(g1), _j2(q7))]))


def test_infinity_degenerates():
    g1, g2 = G1_REF.gen_affine, G2_REF.gen_affine
    assert pr.miller_loop(G1_REF.affine_inf(), g2).is_one()
    assert pr.miller_loop(g1, G2_REF.affine_inf()).is_one()
    assert jpr.miller_loop(JG1_REF.affine_inf(), JG2_REF.gen_affine).is_one()
    assert pr.pairing_check([(G1_REF.affine_inf(), g2)])

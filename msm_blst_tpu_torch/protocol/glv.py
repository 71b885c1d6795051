"""GLV / GLS endomorphisms: fast scalar decomposition and subgroup checks.

Copy of msm_blst_tpu/protocol/glv.py for the port. Capability twin of
blst's endomorphism machinery:
  * G1 GLV mult (beta endomorphism, 2-dim)  — blst's src/e1.c:396-442
  * G2 GLS mult (psi endomorphism, 4-dim)   — blst's src/e2.c:455-516
  * in-group checks                          — src/e1.c:101-138, src/e2.c
  * scalar split                             — src/vect.c:144-176 (div_by_zz/z)

All constants (beta, lambda, the lattice basis) are derived at import from
the curve parameter z and verified against the generator, not transcribed.
"""

from __future__ import annotations

from ..constants import P, R_ORDER
from ..refimpl.curve import G1_REF, G2_REF
from ..refimpl.field import Fp, Fp2
from .hash_to_curve import psi

BLS_X = -0xD201000000010000
_Z2 = BLS_X * BLS_X  # z^2 (positive)

# lambda: eigenvalue of the beta endomorphism on G1 (lambda^2+lambda+1 = 0 mod r)
LAMBDA = (_Z2 - 1) % R_ORDER
assert (LAMBDA * LAMBDA + LAMBDA + 1) % R_ORDER == 0

# beta: primitive cube root of unity in Fp, the one matching LAMBDA on G1.
# Roots of x^2 + x + 1: (-1 +- sqrt(-3))/2; pick by testing against G.
_SQRT_M3 = pow(P - 3, (P + 1) // 4, P)
assert _SQRT_M3 * _SQRT_M3 % P == P - 3


def _pick_beta() -> int:
    g = G1_REF.gen_affine
    target = G1_REF.affine_mult(LAMBDA, g)
    for cand in ((-1 + _SQRT_M3) * pow(2, P - 2, P) % P,
                 (-1 - _SQRT_M3) * pow(2, P - 2, P) % P):
        assert (cand * cand + cand + 1) % P == 0
        if (g[0].mul_small(1) * Fp(cand), g[1]) == target:
            return cand
    raise AssertionError("no cube root matches lambda on G1")


BETA = _pick_beta()
_BETA_FP = Fp(BETA)


def phi(pt):
    """The G1 endomorphism (x, y) -> (beta x, y); acts as [lambda] on G1."""
    if G1_REF.affine_is_inf(pt):
        return pt
    return (pt[0] * _BETA_FP, pt[1])


# ---------------------------------------------------------------------------
# scalar decomposition
# ---------------------------------------------------------------------------

# GLV lattice basis for (a, b) with a + b*lambda = 0 (mod r):
#   v1 = (lambda, -1), v2 = (1, z^2); det = lambda z^2 + 1 = r exactly.
_V1 = (LAMBDA, -1)
_V2 = (1, _Z2)


def glv_decompose(k: int):
    """k mod r -> (k1, k2) with k = k1 + k2*lambda (mod r), |ki| ~ 2^128.

    Babai rounding against the derived basis (the reference does the same
    arithmetic with fixed-point division chains, src/vect.c:144-176).
    """
    k %= R_ORDER
    # solve (c1, c2) = (k, 0) B^-1, B = [v1; v2], det = r
    #   B^-1 = 1/r [[ z^2, 1 ], [ -1, lambda ]]
    c1 = (k * _Z2 + R_ORDER // 2) // R_ORDER
    c2 = (k * 1 + R_ORDER // 2) // R_ORDER
    k1 = k - c1 * _V1[0] - c2 * _V2[0]
    k2 = -c1 * _V1[1] - c2 * _V2[1]
    assert (k1 + k2 * LAMBDA) % R_ORDER == k
    return k1, k2


def gls_decompose(k: int):
    """k mod r -> (k0..k3) with k = sum ki z^i (mod r), |ki| <= |z|/2 + 1.

    Centered base-z digits; valid because psi acts as [z] on G2."""
    k %= R_ORDER
    digits = []
    for _ in range(3):
        rem = k % BLS_X  # Python floor-mod with negative modulus: in (z, 0]
        if rem < BLS_X // 2:  # center: BLS_X < 0, so this pushes toward 0
            rem -= BLS_X
        digits.append(rem)
        k = (k - rem) // BLS_X
    digits.append(k)
    assert abs(k) <= -BLS_X, "top GLS digit out of range"
    return digits


def mult_glv_g1(k: int, pt):
    """[k]P on G1 via 2-dim GLV (refimpl; device path uses booth windows)."""
    k1, k2 = glv_decompose(k)
    p1 = pt if k1 >= 0 else (pt[0], -pt[1])
    q = phi(pt)
    p2 = q if k2 >= 0 else (q[0], -q[1])
    a = G1_REF.jac_mult(abs(k1), G1_REF.from_affine(p1))
    b = G1_REF.jac_mult(abs(k2), G1_REF.from_affine(p2))
    return G1_REF.to_affine(G1_REF.jac_add(a, b))


def mult_gls_g2(k: int, pt):
    """[k]P on G2 via 4-dim GLS: sum_i psi^i([ki]P)."""
    digits = gls_decompose(k)
    acc = G2_REF.jac_inf()
    q = pt
    for ki in digits:
        p_i = q if ki >= 0 else (q[0], -q[1])
        acc = G2_REF.jac_add(acc, G2_REF.jac_mult(abs(ki), G2_REF.from_affine(p_i)))
        q = psi(q)
    return G2_REF.to_affine(acc)


# ---------------------------------------------------------------------------
# subgroup membership
# ---------------------------------------------------------------------------


def in_g1(pt) -> bool:
    """P in G1 iff on-curve and phi(P) + P == [z^2]P (endomorphism check;
    capability twin of blst_p1_affine_in_g1, src/e1.c:101-138).

    Cross-validated against the definitional [r]P == inf in tests.
    """
    if G1_REF.affine_is_inf(pt):
        return True
    if not G1_REF.is_on_curve(pt):
        return False
    lhs = G1_REF.jac_add(G1_REF.from_affine(phi(pt)), G1_REF.from_affine(pt))
    zp = G1_REF.affine_mult(-BLS_X, pt)
    z2p = G1_REF.jac_mult(-BLS_X, G1_REF.from_affine(zp))
    return G1_REF.to_affine(lhs) == G1_REF.to_affine(z2p)


def in_g2(pt) -> bool:
    """Q in G2 iff on-curve and psi(Q) == [z]Q (z < 0: psi(Q) + [|z|]Q == inf)."""
    if G2_REF.affine_is_inf(pt):
        return True
    if not G2_REF.is_on_curve(pt):
        return False
    zq = G2_REF.jac_mult(-BLS_X, G2_REF.from_affine(pt))  # [|z|]Q
    s = G2_REF.jac_add(G2_REF.from_affine(psi(pt)), zq)
    return G2_REF.jac_is_inf(s) or G2_REF.to_affine(s) == G2_REF.affine_inf()

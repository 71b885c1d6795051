"""Optimal ate pairing on BLS12-381 (pure Python, exact).

Copy of msm_blst_tpu/protocol/pairing.py for the port. Capability twin of
blst's pairing stack (src/pairing.c:14-444: Miller loop, n-point batched
Miller loop, final exponentiation). Host-side oracle/protocol implementation; the
MSM engine is the device path, the pairing exists for protocol
parity (signature verification, aggregation).

Design notes:
  * G2 points live on the twist E'/Fp2: y^2 = x^3 + 4(u+1); they are
    untwisted into E(Fp12) via (x, y) -> (x w^-2, y w^-3) (w^6 = xi), and the
    Miller loop runs with transparent affine line functions over Fp12.
    Obviously-correct beats micro-optimized here.
  * e(P, Q) = f_{|z|, Q}(P)^conj then the final exponentiation, with
    z = -0xd201000000010000 (conjugation implements the sign of z, exact up
    to exp-killed subfield factors).
  * The hard part of the final exponentiation uses the cyclotomic structure
    (f^-1 = conj(f)) with a signed-digit expansion of (p^4 - p^2 + 1)/r.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..constants import P, R_ORDER
from ..refimpl.field import Fp, Fp2
from .tower import Fp6, Fp12

# BLS parameter z: p = (z-1)^2 (z^4 - z^2 + 1)/3 + z, r = z^4 - z^2 + 1
BLS_X = -0xD201000000010000
assert (BLS_X**4 - BLS_X**2 + 1) == R_ORDER

_W = Fp12(Fp6.zero(), Fp6.one())  # the tower generator w
_W_INV2 = (_W * _W).inv()  # w^-2
_W_INV3 = (_W * _W * _W).inv()  # w^-3

# exact hard-part exponent (p^4 - p^2 + 1)/r — integral for BLS curves
_HARD_EXP = (P**4 - P**2 + 1) // R_ORDER
assert (P**4 - P**2 + 1) % R_ORDER == 0


def _fp12_from_fp(x: Fp) -> Fp12:
    return Fp12(Fp6(Fp2(x, Fp.zero()), Fp2.zero(), Fp2.zero()), Fp6.zero())


def _fp12_from_fp2(x: Fp2) -> Fp12:
    return Fp12(Fp6(x, Fp2.zero(), Fp2.zero()), Fp6.zero())


def untwist(q_affine) -> Tuple[Fp12, Fp12]:
    """E'(Fp2) affine -> E(Fp12) affine: (x, y) -> (x w^-2, y w^-3)."""
    x, y = q_affine
    return (_fp12_from_fp2(x) * _W_INV2, _fp12_from_fp2(y) * _W_INV3)


def _line(t, q, p_xy) -> Fp12:
    """Evaluate at P the line through T and Q (both on E(Fp12), affine).

    T == Q -> tangent; x_T == x_Q (and not equal) -> vertical line.
    """
    xt, yt = t
    xq, yq = q
    xp, yp = p_xy
    if xt == xq and yt == yq:
        lam = (xt * xt) * _fp12_from_fp(Fp(3)) * (yt + yt).inv()
    elif xt == xq:
        return xp - xt  # vertical
    else:
        lam = (yq - yt) * (xq - xt).inv()
    return yp - yt - lam * (xp - xt)


def _add_affine_fp12(t, q):
    """Affine add (or double) on E(Fp12); inputs distinct-or-equal, not inverse."""
    xt, yt = t
    xq, yq = q
    if xt == xq and yt == yq:
        lam = (xt * xt) * _fp12_from_fp(Fp(3)) * (yt + yt).inv()
    else:
        lam = (yq - yt) * (xq - xt).inv()
    x3 = lam * lam - xt - xq
    y3 = lam * (xt - x3) - yt
    return (x3, y3)


def miller_loop(p_affine, q_affine) -> Fp12:
    """f_{|z|, Q}(P), conjugated for z < 0. Inputs affine over Fp / Fp2.

    Either input at infinity gives 1 (degenerate pairing), matching
    blst_miller_loop's handling.
    """
    px, py = p_affine
    if (px.is_zero() and py.is_zero()) or (
        q_affine[0].is_zero() and q_affine[1].is_zero()
    ):
        return Fp12.one()
    p12 = (_fp12_from_fp(px), _fp12_from_fp(py))
    q12 = untwist(q_affine)
    t = q12
    f = Fp12.one()
    n = -BLS_X
    for i in range(n.bit_length() - 2, -1, -1):
        f = f.sqr() * _line(t, t, p12)
        t = _add_affine_fp12(t, t)
        if (n >> i) & 1:
            f = f * _line(t, q12, p12)
            t = _add_affine_fp12(t, q12)
    return f.conj()  # z < 0: f_{z} = conj(f_{|z|}) up to exp-killed factors


def miller_loop_n(pairs: Sequence[Tuple[object, object]]) -> Fp12:
    """Product of Miller loops (batched pairing accumulation, the capability
    of blst_miller_loop_n / blst_pairing_aggregate: one final exp for many
    pairs)."""
    f = Fp12.one()
    for p_aff, q_aff in pairs:
        f = f * miller_loop(p_aff, q_aff)
    return f


def final_exp(f: Fp12) -> Fp12:
    """f^((p^12 - 1)/r): easy part by Frobenius, hard part by a signed
    square-and-multiply using cyclotomic squaring."""
    if f.is_zero():
        raise ZeroDivisionError("final_exp of zero")
    # easy part: f^(p^6 - 1) then ^(p^2 + 1)
    f = f.conj() * f.inv()
    f = f.frobenius_n(2) * f
    # hard part: now f is cyclotomic (f^conj = f^-1), exponentiate by the
    # exact integer with NAF digits so inversions are free conjugations.
    return _cyclotomic_pow(f, _HARD_EXP)


def _cyclotomic_pow(f: Fp12, e: int) -> Fp12:
    """f^e for f in the cyclotomic subgroup, NAF square-and-multiply."""
    naf = []
    while e:
        if e & 1:
            d = 2 - (e & 3)  # 1 or -1
            e -= d
        else:
            d = 0
        naf.append(d)
        e >>= 1
    r = Fp12.one()
    fi = f.conj()
    for d in reversed(naf):
        r = r.cyclotomic_sqr()
        if d == 1:
            r = r * f
        elif d == -1:
            r = r * fi
    return r


def pairing(p_affine, q_affine) -> Fp12:
    """e(P, Q) for P in G1(Fp) affine, Q in G2(Fp2) affine."""
    return final_exp(miller_loop(p_affine, q_affine))


def multi_pairing(pairs: Sequence[Tuple[object, object]]) -> Fp12:
    """prod_i e(P_i, Q_i) with a single final exponentiation."""
    return final_exp(miller_loop_n(pairs))


def pairing_check(pairs: Sequence[Tuple[object, object]]) -> bool:
    """prod_i e(P_i, Q_i) == 1 — the signature-verification primitive
    (capability of blst_pairing_commit + blst_pairing_finalverify)."""
    return multi_pairing(pairs).is_one()

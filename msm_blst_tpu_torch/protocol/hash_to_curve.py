"""RFC 9380 hash-to-curve for BLS12-381 G1 and G2 (SHA-256 / SSWU / RO + NU).

Copy of msm_blst_tpu/protocol/hash_to_curve.py for the port: the host
oracle the batched device maps (protocol/device_map.py) are held against.
Capability twin of blst's hash-to-curve stack:
  * expand_message_xmd  — blst's src/hash_to_field.c:17-127
  * hash_to_field       — blst's src/hash_to_field.c:129-177
  * SSWU map + isogeny  — blst's src/map_to_g1.c, map_to_g2.c
  * clear cofactor      — G1: (1 - z) scalar mult; G2: the psi-based
                          Budroni-Pintore method (RFC 9380 appendix G.3)

Host-side (hashing is inherently serial bytes work); the batched *field* part
of the map (SSWU + isogeny over many messages) also exists device-side in
protocol/device_map.py. Validated against the reference's JSON fixture
vectors (bindings/vectors/hash_to_curve/*.json) in tests.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

from ..constants import P, R_ORDER
from ..refimpl.curve import G1_REF, G2_REF
from ..refimpl.field import Fp, Fp2
from . import iso_constants as K
from .tower import XI, _fp2_pow, fp2_conj

BLS_X = -0xD201000000010000

# ---------------------------------------------------------------------------
# expand_message_xmd / hash_to_field  (RFC 9380 section 5)
# ---------------------------------------------------------------------------

_B_IN_BYTES = 32  # SHA-256 output
_R_IN_BYTES = 64  # SHA-256 block
_L = 64  # ceil((381 + 128) / 8), per ciphersuite


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = -(-len_in_bytes // _B_IN_BYTES)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(_R_IN_BYTES)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = hashlib.sha256(b0 + b"\x01" + dst_prime).digest()
    out = [b1]
    for i in range(2, ell + 1):
        prev = out[-1]
        mixed = bytes(x ^ y for x, y in zip(b0, prev))
        out.append(hashlib.sha256(mixed + bytes([i]) + dst_prime).digest())
    return b"".join(out)[:len_in_bytes]


def hash_to_field_fp(msg: bytes, dst: bytes, count: int):
    """count elements of Fp (m = 1)."""
    uniform = expand_message_xmd(msg, dst, count * _L)
    return [
        Fp(int.from_bytes(uniform[i * _L : (i + 1) * _L], "big"))
        for i in range(count)
    ]


def hash_to_field_fp2(msg: bytes, dst: bytes, count: int):
    """count elements of Fp2 (m = 2)."""
    uniform = expand_message_xmd(msg, dst, count * 2 * _L)
    out = []
    for i in range(count):
        c0 = int.from_bytes(uniform[(2 * i) * _L : (2 * i + 1) * _L], "big")
        c1 = int.from_bytes(uniform[(2 * i + 1) * _L : (2 * i + 2) * _L], "big")
        out.append(Fp2(c0, c1))
    return out


# ---------------------------------------------------------------------------
# field square roots / sign
# ---------------------------------------------------------------------------


def sqrt_fp(a: Fp):
    """sqrt mod P (P = 3 mod 4); None if non-residue. Spec twin of
    blst's src/sqrt.c."""
    r = pow(a.v, (P + 1) // 4, P)
    return Fp(r) if r * r % P == a.v else None


def sqrt_fp2(a: Fp2):
    """sqrt in Fp2 via the norm trick; None if non-residue."""
    if a.is_zero():
        return Fp2.zero()
    lam = sqrt_fp(a.c0 * a.c0 + a.c1 * a.c1)
    if lam is None:
        return None
    inv2 = Fp(pow(2, P - 2, P))
    for l in (lam, -lam):
        t = (a.c0 + l) * inv2
        y0 = sqrt_fp(t)
        if y0 is None or y0.is_zero():
            continue
        y1 = a.c1 * (y0 + y0).inv()
        cand = Fp2(y0, y1)
        if cand.sqr() == a:
            return cand
    # pure-imaginary edge: a = (c0, 0) with -c0 a residue -> (0, sqrt(-c0))
    if a.c1.is_zero():
        y1 = sqrt_fp(-a.c0)
        if y1 is not None:
            return Fp2(Fp.zero(), y1)
    return None


def is_square_fp(a: Fp) -> bool:
    return a.is_zero() or pow(a.v, (P - 1) // 2, P) == 1


def is_square_fp2(a: Fp2) -> bool:
    # x is square in Fp2 iff its norm x^(p+1) is square in Fp
    return is_square_fp(a.c0 * a.c0 + a.c1 * a.c1)


def sgn0_fp(a: Fp) -> int:
    return a.v & 1


def sgn0_fp2(a: Fp2) -> int:
    sign_0 = a.c0.v & 1
    zero_0 = a.c0.v == 0
    return sign_0 | (zero_0 & (a.c1.v & 1))


# ---------------------------------------------------------------------------
# simplified SWU (RFC 9380 section 6.6.2) + isogeny evaluation
# ---------------------------------------------------------------------------


def _sswu(u, A, B, Z, sqrt, is_square, sgn0):
    """Map u to the isogenous curve y^2 = x^3 + A x + B. Field-generic."""
    tv1 = Z * u.sqr()
    tv2 = tv1.sqr() + tv1
    if tv2.is_zero():
        x1 = B * (Z * A).inv()  # exceptional case: x1 = B / (Z A)
    else:
        x1 = (-B) * A.inv() * (tv2.inv() + type(u).one())
    gx1 = (x1.sqr() + A) * x1 + B
    if is_square(gx1):
        x, y = x1, sqrt(gx1)
    else:
        x2 = tv1 * x1
        gx2 = (x2.sqr() + A) * x2 + B
        x, y = x2, sqrt(gx2)
    if sgn0(u) != sgn0(y):
        y = -y
    return x, y


def _horner(coeffs, x):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * x + c
    return acc


def _iso_map(x, y, xnum, xden, ynum, yden):
    """Evaluate the rational isogeny (denominators monic: leading 1 implicit,
    same convention as map_fp in blst's src/map_to_g1.c:36-41)."""
    xn = _horner(xnum, x)
    xd = _horner(xden + [type(x).one()], x)
    yn = _horner(ynum, x)
    yd = _horner(yden + [type(x).one()], x)
    return xn * xd.inv(), y * yn * yd.inv()


_G1_A = Fp(K.G1_A)
_G1_B = Fp(K.G1_B)
_G1_Z = Fp(K.G1_SSWU_Z)
_G1_XNUM = [Fp(v) for v in K.G1_XNUM]
_G1_XDEN = [Fp(v) for v in K.G1_XDEN]
_G1_YNUM = [Fp(v) for v in K.G1_YNUM]
_G1_YDEN = [Fp(v) for v in K.G1_YDEN]

_G2_A = Fp2(*K.G2_A)
_G2_B = Fp2(*K.G2_B)
_G2_Z = Fp2(*K.G2_SSWU_Z)
_G2_XNUM = [Fp2(*v) for v in K.G2_XNUM]
_G2_XDEN = [Fp2(*v) for v in K.G2_XDEN]
_G2_YNUM = [Fp2(*v) for v in K.G2_YNUM]
_G2_YDEN = [Fp2(*v) for v in K.G2_YDEN]


def map_to_curve_g1(u: Fp):
    """SSWU + 11-isogeny: Fp -> E1 affine (not yet in G1)."""
    x, y = _sswu(u, _G1_A, _G1_B, _G1_Z, sqrt_fp, is_square_fp, sgn0_fp)
    return _iso_map(x, y, _G1_XNUM, _G1_XDEN, _G1_YNUM, _G1_YDEN)


def map_to_curve_g2(u: Fp2):
    """SSWU + 3-isogeny: Fp2 -> E2 affine (not yet in G2)."""
    x, y = _sswu(u, _G2_A, _G2_B, _G2_Z, sqrt_fp2, is_square_fp2, sgn0_fp2)
    return _iso_map(x, y, _G2_XNUM, _G2_XDEN, _G2_YNUM, _G2_YDEN)


# ---------------------------------------------------------------------------
# cofactor clearing
# ---------------------------------------------------------------------------

G1_H_EFF = 1 - BLS_X  # 0xd201000000010001 (RFC 9380 section 8.8.1)


def clear_cofactor_g1(pt):
    return G1_REF.affine_mult(G1_H_EFF, pt)


# psi: untwist-Frobenius-twist endomorphism on E2.
# Derived from the tower: psi(x, y) = (c_x conj(x), c_y conj(y)) with
# c_x = xi^-(p-1)/3, c_y = xi^-(p-1)/2 (w^(p-1) = xi^((p-1)/6)).
_PSI_CX = _fp2_pow(XI, (P - 1) // 3).inv()
_PSI_CY = _fp2_pow(XI, (P - 1) // 2).inv()


def psi(pt):
    """The G2 endomorphism; acts as multiplication by z on G2
    (spec twin: blst's src/e2.c psi at :455-516)."""
    x, y = pt
    return (_PSI_CX * fp2_conj(x), _PSI_CY * fp2_conj(y))


def psi2(pt):
    return psi(psi(pt))


def clear_cofactor_g2(pt):
    """Budroni-Pintore: h_eff P = [z^2-z-1]P + [z-1]psi(P) + psi2(2P)
    (RFC 9380 appendix G.3; z < 0 handled by negation)."""
    C = G2_REF

    def mult_z(p_aff):  # [z]P with z negative
        q = C.affine_mult(-BLS_X, p_aff)
        return (q[0], -q[1]) if not C.affine_is_inf(q) else q

    def add(a, b):
        return C.to_affine(C.jac_add(C.from_affine(a), C.from_affine(b)))

    def neg(a):
        return a if C.affine_is_inf(a) else (a[0], -a[1])

    t1 = mult_z(pt)
    t2 = psi(pt)
    t3 = psi2(C.to_affine(C.jac_double(C.from_affine(pt))))
    t3 = add(t3, neg(t2))
    t2 = add(t1, t2)
    t2 = mult_z(t2)
    t3 = add(t3, t2)
    t3 = add(t3, neg(t1))
    return add(t3, neg(pt))


# ---------------------------------------------------------------------------
# top-level suites
# ---------------------------------------------------------------------------

DST_G1_RO = b"BLS12381G1_XMD:SHA-256_SSWU_RO_"
DST_G1_NU = b"BLS12381G1_XMD:SHA-256_SSWU_NU_"
DST_G2_RO = b"BLS12381G2_XMD:SHA-256_SSWU_RO_"
DST_G2_NU = b"BLS12381G2_XMD:SHA-256_SSWU_NU_"


def hash_to_g1(msg: bytes, dst: bytes = DST_G1_RO):
    """Random-oracle hash to G1 (blst_hash_to_g1 twin). Affine int pair."""
    u0, u1 = hash_to_field_fp(msg, dst, 2)
    q0 = map_to_curve_g1(u0)
    q1 = map_to_curve_g1(u1)
    q = G1_REF.to_affine(G1_REF.jac_add(G1_REF.from_affine(q0), G1_REF.from_affine(q1)))
    out = clear_cofactor_g1(q)
    return (out[0].v, out[1].v)


def encode_to_g1(msg: bytes, dst: bytes = DST_G1_NU):
    """Nonuniform encoding to G1 (blst_encode_to_g1 twin)."""
    (u0,) = hash_to_field_fp(msg, dst, 1)
    out = clear_cofactor_g1(map_to_curve_g1(u0))
    return (out[0].v, out[1].v)


def hash_to_g2(msg: bytes, dst: bytes = DST_G2_RO):
    """Random-oracle hash to G2 (blst_hash_to_g2 twin)."""
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    q0 = map_to_curve_g2(u0)
    q1 = map_to_curve_g2(u1)
    q = G2_REF.to_affine(G2_REF.jac_add(G2_REF.from_affine(q0), G2_REF.from_affine(q1)))
    out = clear_cofactor_g2(q)
    return ((out[0].c0.v, out[0].c1.v), (out[1].c0.v, out[1].c1.v))


def encode_to_g2(msg: bytes, dst: bytes = DST_G2_NU):
    (u0,) = hash_to_field_fp2(msg, dst, 1)
    out = clear_cofactor_g2(map_to_curve_g2(u0))
    return ((out[0].c0.v, out[0].c1.v), (out[1].c0.v, out[1].c1.v))

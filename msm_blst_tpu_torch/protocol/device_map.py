"""Batched SSWU maps for hash-to-curve on the device (G1 and G2).

Port of msm_blst_tpu/protocol/device_map.py. The byte half of hash to curve
(expand_message_xmd) is host work; the field half — SSWU, the isogeny and
the cofactor clearing — is batched field arithmetic over all messages:

    msgs --host sha256--> u[2n] --device--> affine G1 points (in the group)

On the card every field product is one K1 launch (fields/cuda_mont.py) over
the whole batch, and every point add and doubling one K2 launch
(curves/cuda_point.py); CPU tensors take their plain twins. Square roots
are exponent chains (p = 3 mod 4 for Fp; Adj and Rodriguez-Henriquez for
Fp2), branch-free per lane.

Where the JAX module runs two chains that do not depend on each other (the
square roots of g(x1) and g(x2)), this one runs one chain over both batches
side by side, and the constants it inverts on the device (-B/A, B/(Z A))
are worked out on the host: the words are the same, with fewer launches.
"""

from __future__ import annotations

import functools

import torch

from ..constants import P
from ..curves import G1, AffinePoint, point_mult
from ..device import resolve
from ..fields.fp2 import FP2
from ..fields.limb import FP, int_to_words
from ..msm import recode
from ..refimpl.field import Fp, Fp2
from . import iso_constants as K

BLS_X = -0xD201000000010000
G1_H_EFF = 1 - BLS_X


@functools.lru_cache(maxsize=None)
def _mont_words(x: int, device: str) -> torch.Tensor:
    """int32[12, 1]: x's Montgomery words (x R mod p) on `device`."""
    w = int_to_words(x % P * FP.R % P, FP.n_words)
    return torch.as_tensor(w, device=device).reshape(FP.n_words, 1)


def _mont_const_fp(x: int, batch, device) -> torch.Tensor:
    """x in Montgomery form, broadcast to int32[12, *batch]."""
    c = _mont_words(x, str(device))
    return c.reshape((FP.n_words,) + (1,) * len(batch)).expand(
        (FP.n_words,) + tuple(batch))


def _mont_const_fp2(x0: int, x1: int, batch, device) -> torch.Tensor:
    return FP2.build(_mont_const_fp(x0, batch, device),
                     _mont_const_fp(x1, batch, device))


def _split(t: torch.Tensor):
    """A batch of 2n lanes -> its first and second n."""
    n = t.shape[-1] // 2
    return t[..., :n], t[..., n:]


# x1's two constants of the SSWU map, (-B/A) and B/(Z A), on the host
_G1_MB_OVER_A = (-Fp(K.G1_B) * Fp(K.G1_A).inv()).v
_G1_B_OVER_ZA = (Fp(K.G1_B) * (Fp(K.G1_SSWU_Z) * Fp(K.G1_A)).inv()).v
_G2_A, _G2_B, _G2_Z = Fp2(*K.G2_A), Fp2(*K.G2_B), Fp2(*K.G2_SSWU_Z)
_G2_MB_OVER_A = -_G2_B * _G2_A.inv()
_G2_B_OVER_ZA = _G2_B * (_G2_Z * _G2_A).inv()


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------


def _sswu_g1(u):
    """u: Montgomery int32[12, n] -> (x, y) on the isogenous curve E1'."""
    batch, dev = u.shape[1:], u.device
    A = _mont_const_fp(K.G1_A, batch, dev)
    B = _mont_const_fp(K.G1_B, batch, dev)
    Z = _mont_const_fp(K.G1_SSWU_Z, batch, dev)
    one = FP.one_mont(batch, dev)

    u2 = FP.sqr(u)
    tv1 = FP.mul(Z, u2)
    tv2 = FP.add(FP.sqr(tv1), tv1)
    tv2_zero = FP.is_zero(tv2)
    # x1 = (-B/A) (1 + 1/tv2), exceptional (tv2 = 0): B/(Z A)
    inv_tv2 = FP.inv(tv2)  # inv(0) = 0 -> handled by the select below
    x1_main = FP.mul(_mont_const_fp(_G1_MB_OVER_A, batch, dev),
                     FP.add(one, inv_tv2))
    x1_exc = _mont_const_fp(_G1_B_OVER_ZA, batch, dev)
    x1 = FP.select(tv2_zero, x1_exc, x1_main)
    x2 = FP.mul(tv1, x1)
    # g(x1) and g(x2) side by side, one square-root chain for both
    xs = torch.cat([x1, x2], dim=-1)
    A2, B2 = (torch.cat([c, c], dim=-1) for c in (A, B))
    gx = FP.add(FP.mul(FP.add(FP.sqr(xs), A2), xs), B2)
    ys = FP.pow_int(gx, (P + 1) // 4)
    gx1, _ = _split(gx)
    y1, y2 = _split(ys)
    ok1 = FP.eq(FP.sqr(y1), gx1)
    x = FP.select(ok1, x1, x2)
    y = FP.select(ok1, y1, y2)
    # sgn0 fixup: parity of canonical u vs canonical y (bit 0 of word 0)
    canon_u, canon_y = _split(FP.from_mont(torch.cat([u, y], dim=-1)))
    y = FP.cneg(y, (canon_u[0] & 1) != (canon_y[0] & 1))
    return x, y


def _iso_g1(x, y):
    batch, dev = x.shape[1:], x.device

    def horner(coeffs, monic):
        acc = (FP.one_mont(batch, dev) if monic
               else _mont_const_fp(coeffs[-1], batch, dev))
        cs = coeffs if monic else coeffs[:-1]
        for c in reversed(cs):
            acc = FP.add(FP.mul(acc, x), _mont_const_fp(c, batch, dev))
        return acc

    xn = horner(K.G1_XNUM, monic=False)
    xd = horner(K.G1_XDEN, monic=True)
    yn = horner(K.G1_YNUM, monic=False)
    yd = horner(K.G1_YDEN, monic=True)
    inv_xd_yd = FP.inv(FP.mul(xd, yd))  # one inversion chain for both
    x_out = FP.mul(FP.mul(xn, inv_xd_yd), yd)
    y_out = FP.mul(y, FP.mul(FP.mul(yn, inv_xd_yd), xd))
    return AffinePoint(x_out, y_out)


def _clear_cofactor_g1(pt: AffinePoint) -> AffinePoint:
    """h_eff * pt per lane (point_mult at w = 4 over 256-bit scalars), in
    affine."""
    n = pt.X.shape[-1]
    sc = recode.to_device(recode.scalars_from_ints([G1_H_EFF] * n),
                          pt.X.device)
    return G1.jac_to_affine(point_mult(G1, sc, pt, w=4))


def map_to_g1_device(u, clear_cofactor: bool = True,
                     device=None) -> AffinePoint:
    """Montgomery u-batch int32[12, n] -> AffinePoint batch on G1 (on E1
    without `clear_cofactor`), computed on `device` (default: the card)."""
    pt = _iso_g1(*_sswu_g1(u.to(resolve(device))))
    return _clear_cofactor_g1(pt) if clear_cofactor else pt


def hash_to_g1_device(msgs, dst: bytes = None, device=None) -> AffinePoint:
    """Host hashing + device map for a batch of messages (RO suite) on
    `device` (default: the card): per message u0, u1 mapped side by side,
    q0 + q1 by one K2 add, then the cofactor cleared."""
    from .hash_to_curve import DST_G1_RO, hash_to_field_fp

    dst = dst or DST_G1_RO
    us = []
    for m in msgs:
        u0, u1 = hash_to_field_fp(m, dst, 2)
        us.extend([u0.v, u1.v])
    return _run_hash_to_g1(FP.from_ints(us, device=resolve(device)))


def _run_hash_to_g1(u_dev) -> AffinePoint:
    """Montgomery int32[12, 2n], u0 and u1 of each message interleaved ->
    the n affine points h_eff (map(u0) + map(u1)), where u_dev lies."""
    q = _iso_g1(*_sswu_g1(u_dev))
    q0 = AffinePoint(*(c[..., 0::2] for c in q))
    q1 = AffinePoint(*(c[..., 1::2] for c in q))
    summed = G1.xyzz_to_affine(G1.xyzz_dadd_affine(G1.xyzz_from_affine(q0),
                                                   q1))
    return _clear_cofactor_g1(summed)


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------


def _mul_by_i(a):
    """(c0 + c1 i) * i = -c1 + c0 i (no field multiply)."""
    return FP2.build(FP.neg(a[1]), a[0])


def _sqrt_fp2_device(a):
    """Fp2 square root for p = 3 mod 4 (Adj and Rodriguez-Henriquez):
      a1 = a^((p-3)/4); x0 = a1 a; alpha = a1 x0 = a^((p-1)/2)
      x = i x0                     if alpha == -1
          (1+alpha)^((p-1)/2) x0   otherwise
    Returns (root, ok) — ok False where a is a non-residue."""
    batch, dev = a.shape[2:], a.device
    one = FP2.one_mont(batch, dev)
    a1 = FP2.pow_int(a, (P - 3) // 4)
    x0 = FP2.mul(a1, a)
    alpha = FP2.mul(a1, x0)
    minus_one = FP2.neg(one)
    b = FP2.pow_int(FP2.add(one, alpha), (P - 1) // 2)
    x = FP2.select(FP2.eq(alpha, minus_one), _mul_by_i(x0), FP2.mul(b, x0))
    ok = FP2.eq(FP2.sqr(x), a)
    return x, ok


def _sgn0_fp2_device(a):
    """RFC 9380 sgn0 for Fp2 (canonical): sign(c0) or (c0 == 0 and
    sign(c1)); both components leave Montgomery form in one product."""
    c = FP.from_mont(a.movedim(0, 1))  # (12, 2, *batch)
    c0, c1 = c[:, 0], c[:, 1]
    s0 = (c0[0] & 1) != 0
    z0 = FP.is_zero(c0)
    s1 = (c1[0] & 1) != 0
    return s0 | (z0 & s1)


def _sswu_g2(u):
    batch, dev = u.shape[2:], u.device
    A = _mont_const_fp2(*K.G2_A, batch, dev)
    B = _mont_const_fp2(*K.G2_B, batch, dev)
    Z = _mont_const_fp2(*K.G2_SSWU_Z, batch, dev)
    one = FP2.one_mont(batch, dev)

    tv1 = FP2.mul(Z, FP2.sqr(u))
    tv2 = FP2.add(FP2.sqr(tv1), tv1)
    tv2_zero = FP2.is_zero(tv2)
    inv_tv2 = FP2.inv(tv2)
    c = _G2_MB_OVER_A
    x1_main = FP2.mul(_mont_const_fp2(c.c0.v, c.c1.v, batch, dev),
                      FP2.add(one, inv_tv2))
    c = _G2_B_OVER_ZA
    x1_exc = _mont_const_fp2(c.c0.v, c.c1.v, batch, dev)
    x1 = FP2.select(tv2_zero, x1_exc, x1_main)
    x2 = FP2.mul(tv1, x1)
    # g(x1) and g(x2) side by side, one square root for both
    xs = torch.cat([x1, x2], dim=-1)
    A2, B2 = (torch.cat([c, c], dim=-1) for c in (A, B))
    gx = FP2.add(FP2.mul(FP2.add(FP2.sqr(xs), A2), xs), B2)
    ys, oks = _sqrt_fp2_device(gx)
    y1, y2 = _split(ys)
    ok1, _ = _split(oks)
    x = FP2.select(ok1, x1, x2)
    y = FP2.select(ok1, y1, y2)
    sgn_u, sgn_y = _split(_sgn0_fp2_device(torch.cat([u, y], dim=-1)))
    return x, FP2.cneg(y, sgn_u != sgn_y)


def _iso_g2(x, y):
    batch, dev = x.shape[2:], x.device

    def horner(coeffs, monic):
        acc = (FP2.one_mont(batch, dev) if monic
               else _mont_const_fp2(*coeffs[-1], batch, dev))
        cs = coeffs if monic else coeffs[:-1]
        for c in reversed(cs):
            acc = FP2.add(FP2.mul(acc, x), _mont_const_fp2(*c, batch, dev))
        return acc

    xn = horner(K.G2_XNUM, monic=False)
    xd = horner(K.G2_XDEN, monic=True)
    yn = horner(K.G2_YNUM, monic=False)
    yd = horner(K.G2_YDEN, monic=True)
    inv = FP2.inv(FP2.mul(xd, yd))
    return AffinePoint(
        FP2.mul(FP2.mul(xn, inv), yd), FP2.mul(y, FP2.mul(FP2.mul(yn, inv), xd)))


def map_to_g2_device(u, device=None) -> AffinePoint:
    """Montgomery u-batch int32[2, 12, n] -> AffinePoint batch on E2, on
    `device` (default: the card). The cofactor is NOT cleared, as in the
    JAX package (the psi-based clearing is host-side)."""
    return _iso_g2(*_sswu_g2(u.to(resolve(device))))

"""Batched single-point scalar multiplication (signed windows and the XZ
Montgomery ladder), the windowed MSM and the bulk add.

Port of msm_blst_tpu/curves/mult.py: the capability twins of the
reference's single-mult machinery (POINTonE1_mult_w5, ec_mult.h:67-199;
blst_p1s_mult_wbits, multi_scalar.c:81-261; the multiply by the group
order of the subgroup check, e1.c:101-138; the ladder of ec_ops.h:329-465).

One lane per (scalar, point) pair. Each `jax.lax.scan` of the JAX module
is a Python loop over the digit rows here, so on the card every doubling,
add and tree level is one K2 launch over all lanes, and every unfused
field product (the ladder's XZ formulas, the batch inversions) one K1 (or
K6) launch. The formulas and their order are JAX's, so with canonical
field values the results are the same words.
"""

from __future__ import annotations

import torch

from ..constants import R_ORDER
from ..msm import recode
from .ops import AffinePoint, CurveOps, JacPoint, XyzzPoint


def _signed_window_digits(scalars: torch.Tensor, w: int, nbits: int = 256):
    """int32[8, n] -> (|digit| int32[h, n], sign bool[h, n]), digits in
    [-2^(w-1), 2^(w-1)] with sum d_j 2^(w j) == scalar."""
    return recode.signed_digits_device(scalars, w, -(-nbits // w))


def _multiples_table(curve: CurveOps, points: AffinePoint,
                     k: int) -> AffinePoint:
    """Affine table T[d] = d*P per lane, d = 0..k: coordinates (*F.lead,
    k+1, n), row 0 the infinity (0, 0). A chain of k - 1 mixed adds and
    one batch inversion for the whole table."""
    acc = curve.xyzz_from_affine(points)
    rows = [acc]
    for _ in range(k - 1):
        acc = curve.xyzz_dadd_affine(acc, points)
        rows.append(acc)
    n = points.X.shape[-1]
    flat = XyzzPoint(*(torch.stack(cs, dim=-2).reshape(cs[0].shape[:-1]
                                                       + (k * n,))
                       for cs in zip(*rows)))
    aff = curve.xyzz_to_affine(flat)
    return AffinePoint(*(torch.cat([c.new_zeros(c.shape[:-1] + (1, n)),
                                    c.reshape(c.shape[:-1] + (k, n))], dim=-2)
                         for c in aff))


def _gather_rows(table: AffinePoint, idx: torch.Tensor) -> AffinePoint:
    """table coordinates (..., k+1, n); idx int[n] -> coordinates (..., n):
    lane i's row idx[i]."""

    def g(c):
        ix = idx.to(torch.int64).expand(c.shape[:-2] + (1, c.shape[-1]))
        return c.gather(-2, ix)[..., 0, :]

    return AffinePoint(g(table.X), g(table.Y))


def point_mult(curve: CurveOps, scalars: torch.Tensor, points: AffinePoint,
               w: int = 5) -> JacPoint:
    """out[i] = scalars[i] * points[i], batched (blst_p1_mult twin).

    scalars: int32[8, n] (recode.to_device) on the points' device."""
    absd, sign = _signed_window_digits(scalars, w)  # [h, n]
    table = _multiples_table(curve, points, 1 << (w - 1))
    acc = curve.xyzz_inf(curve.bshape(points.X), points.X.device)
    for j in range(absd.shape[0] - 1, -1, -1):
        pt = _gather_rows(table, absd[j])
        for _ in range(w):
            acc = curve.xyzz_double(acc)
        acc = curve.xyzz_dadd_affine(acc, pt, subtract=sign[j])
    return curve.xyzz_to_jac(acc)


def point_mult_ints(curve: CurveOps, ks, points: AffinePoint,
                    w: int = 5) -> JacPoint:
    """point_mult with host-int scalars (taken mod 2^256)."""
    sc = recode.scalars_from_ints([k % (1 << 256) for k in ks])
    return point_mult(curve, recode.to_device(sc, points.X.device), points, w)


def in_group_device(curve: CurveOps, points: AffinePoint, w: int = 5):
    """bool[n]: r * P == inf per lane (the definitional subgroup check)."""
    sc = recode.scalars_from_ints([R_ORDER] * points.X.shape[-1])
    out = point_mult(curve, recode.to_device(sc, points.X.device), points, w)
    return curve.jac_is_inf(out)


def msm_wbits(curve: CurveOps, scalars: torch.Tensor, points: AffinePoint,
              w: int = 5, table: AffinePoint = None) -> JacPoint:
    """2-step windowed MSM: per-point multiple tables, then per window a
    gather and a lane-tree reduction (blst_p1s_mult_wbits twin,
    multi_scalar.c:81-261). A prebuilt `table` (_multiples_table with the
    same w) reuses the precomputation across calls."""
    absd, sign = _signed_window_digits(scalars, w)  # [h, n]
    if table is None:
        table = _multiples_table(curve, points, 1 << (w - 1))
    acc = curve.xyzz_inf((1,), scalars.device)
    for j in range(absd.shape[0] - 1, -1, -1):
        pts = _gather_rows(table, absd[j])
        tile = curve.tree_reduce_xyzz(curve.xyzz_from_affine(pts,
                                                             negate=sign[j]))
        for _ in range(w):
            acc = curve.xyzz_double(acc)
        acc = curve.xyzz_dadd(acc, tile)
    return curve.xyzz_to_jac(acc)


def points_add(curve: CurveOps, points: AffinePoint) -> JacPoint:
    """Sum of a batch of affine points (blst_p1s_add twin): a log-depth
    lane tree of xyzz adds."""
    return curve.xyzz_to_jac(curve.tree_reduce_xyzz(
        curve.xyzz_from_affine(points)))


# ---------------------------------------------------------------------------
# XZ Montgomery ladder
# ---------------------------------------------------------------------------


def _b_const(curve: CurveOps, batch, device) -> torch.Tensor:
    """The curve constant b in the port's Montgomery words, broadcast to
    `batch` on `device`."""
    F = curve.F
    if curve.name == "G1":
        b = F.from_ints([curve.b_int], device=device)
    else:
        b = F.from_int_pairs([curve.b_int], device=device)
    return b.reshape(F.lead + (1,) * len(batch)).expand(
        F.lead + tuple(batch)).contiguous()


def ladder_mult(curve: CurveOps, scalars: torch.Tensor,
                points: AffinePoint) -> JacPoint:
    """Branch-free XZ Montgomery ladder: out[i] = scalars[i] * points[i].

    An x-only ladder over 256 fixed bits with lane swaps, then the
    algebraic y recovery from (x, y, x(kP), x((k+1)P)):
        y1 = (x^3 + x1^3 + 2b - (x2 + x1 + x)(x1 - x)^2) / (2 y).
    The start at infinity is (X, Z) = (1, 0), which the a = 0 XZ formulas
    keep. Edge lanes: k = 0 (Z1 = 0) and P at infinity give infinity, k =
    r - 1 (Z2 = 0) gives -P."""
    F = curve.F
    x, y = points.X, points.Y
    batch, dev = curve.bshape(x), x.device
    b = _b_const(curve, batch, dev)
    one = F.one_mont(batch, dev)
    zero = F.zeros(batch, dev)

    def xdbl(X, Z):
        X2, Z2s = F.mul_many([(X, X), (Z, Z)])
        X3, Z3c = F.mul_many([(X2, X), (Z2s, Z)])
        Xn = F.sub(F.mul(X2, X2), F.mul8(F.mul(b, F.mul(X, Z3c))))
        Zn = F.mul(F.double(F.double(Z)), F.add(X3, F.mul(b, Z3c)))
        return Xn, Zn

    def xadd(X1, Z1, X2, Z2):
        A, Bv, Cv, Dv = F.mul_many([(X1, X2), (Z1, Z2), (X1, Z2), (X2, Z1)])
        Xn = F.sub(F.mul(A, A), F.mul(F.double(F.double(F.mul(b, Bv))),
                                      F.add(Cv, Dv)))
        diff = F.sub(Cv, Dv)
        Zn = F.mul(x, F.mul(diff, diff))
        return Xn, Zn

    bits = recode.qary_digits_device(scalars, 1, 256)  # [256, n], LSB first
    X0, Z0, X1, Z1 = one, zero, x, one  # (inf, P)
    for j in range(255, -1, -1):
        sw = bits[j] != 0
        A, B = F.select(sw, X1, X0), F.select(sw, Z1, Z0)
        C, D = F.select(sw, X0, X1), F.select(sw, Z0, Z1)
        Cn, Dn = xadd(A, B, C, D)
        An, Bn = xdbl(A, B)
        X0, Z0 = F.select(sw, Cn, An), F.select(sw, Dn, Bn)
        X1, Z1 = F.select(sw, An, Cn), F.select(sw, Bn, Dn)

    # y recovery
    zinv = F.batch_inv(torch.cat([Z0, Z1], dim=-1))
    k = Z0.shape[-1]
    x1 = F.mul(X0, zinv[..., :k])
    x2 = F.mul(X1, zinv[..., k:])
    x3c, x13 = F.mul_many([(F.mul(x, x), x), (F.mul(x1, x1), x1)])
    d = F.sub(x1, x)
    num = F.sub(F.add(F.add(x3c, x13), F.double(b)),
                F.mul(F.add(F.add(x2, x1), x), F.mul(d, d)))
    y1 = F.mul(num, F.inv(F.double(y)))
    out = curve.jac_from_affine(AffinePoint(x1, y1))
    minus_p = curve.jac_from_affine(AffinePoint(x, F.neg(y)))
    out = curve.select(F.is_zero(Z1), minus_p, out)
    return curve.select(F.is_zero(Z0) | curve.affine_is_inf(points),
                        curve.jac_inf(batch, dev), out)

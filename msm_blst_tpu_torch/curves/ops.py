"""Branch-free batched point arithmetic in xyzz and Jacobian coordinates.

Port of msm_blst_tpu/curves/ops.py (a = 0 short Weierstrass), over a field
object F: Fp (G1, coordinates int32[12, *batch]) or Fp2 (G2, int32[2, 12,
*batch]); the batch follows the field's leading axes `F.lead`, as JAX's
`_bshape` / `_restore`. Every case is computed over the whole batch and
lane-selected with `where` (the doubling branch of the adds only when some
lane doubles, as the JAX bodies' cond_dbl); the formulas take the same
steps in the same order as the JAX bodies, so with canonical field values
they give the same words.

Infinity conventions (as refimpl and the JAX package):
  affine: (0, 0) | Jacobian: Z == 0 | xyzz: ZZ == 0 and ZZZ == 0.

The three hot formulas (`xyzz_dadd_affine`, `xyzz_dadd`, `xyzz_double`) go
through curves/cuda_point.py: the Hopper kernel for CUDA tensors, the plain
`*_body` formulas below for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_point


class AffinePoint(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor


class JacPoint(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor
    Z: torch.Tensor


class XyzzPoint(NamedTuple):
    X: torch.Tensor
    Y: torch.Tensor
    ZZZ: torch.Tensor
    ZZ: torch.Tensor


class PackedRows32(NamedTuple):
    """Affine table as one row-major int32 array (N, 2W): X words || Y words
    per row, W = F.n_words (96 B per G1 point; 192 B per G2 point, each
    coordinate c0 words || c1 words) — the JAX PackedRows32 row, bit for
    bit, so the port gathers words and never unpacks limbs."""

    XY: torch.Tensor


class CurveOps:
    """Batched point ops over a field-ops object F (LimbField or Fp2Ops)."""

    def __init__(self, F, name: str):
        self.F = F
        self.name = name

    def bshape(self, coord) -> tuple:
        """The batch shape of a coordinate: its axes after F.lead."""
        return tuple(coord.shape[len(self.F.lead):])

    # ---- lifts / predicates ---------------------------------------------------
    def select(self, mask, a, b):
        """Lane-select between two like-typed points."""
        return type(a)(*(torch.where(mask, x, y) for x, y in zip(a, b)))

    def affine_is_inf(self, p: AffinePoint):
        return self.F.is_zero(p.X) & self.F.is_zero(p.Y)

    def affine_inf(self, batch_shape=(), device=None):
        z = self.F.zeros(batch_shape, device)
        return AffinePoint(z, z)

    def jac_is_inf(self, p: JacPoint):
        return self.F.is_zero(p.Z)

    def jac_inf(self, batch_shape=(), device=None):
        one = self.F.one_mont(batch_shape, device)
        return JacPoint(one, one, self.F.zeros(batch_shape, device))

    def jac_from_affine(self, p: AffinePoint) -> JacPoint:
        """Lift affine to Jacobian (Z = 1); infinity to jac_inf."""
        shape, dev = self.bshape(p.X), p.X.device
        return self.select(self.affine_is_inf(p), self.jac_inf(shape, dev),
                           JacPoint(p.X, p.Y, self.F.one_mont(shape, dev)))

    def xyzz_is_inf(self, p: XyzzPoint):
        return self.F.is_zero(p.ZZ) & self.F.is_zero(p.ZZZ)

    def xyzz_inf(self, batch_shape=(), device=None):
        z = self.F.zeros(batch_shape, device)
        return XyzzPoint(z, z, z, z)

    def xyzz_from_affine(self, p: AffinePoint, negate=None) -> XyzzPoint:
        """Lift affine to xyzz; optional per-lane negation mask."""
        F = self.F
        y = p.Y if negate is None else F.cneg(p.Y, negate)
        inf = self.affine_is_inf(p)
        shape = self.bshape(p.X)
        zz = F.select(inf, F.zeros(shape, p.X.device),
                      F.one_mont(shape, p.X.device))
        return XyzzPoint(p.X, y, zz, zz)

    # ---- the three kernel-backed xyzz formulas --------------------------------
    def xyzz_double(self, p: XyzzPoint) -> XyzzPoint:
        return cuda_point.xyzz_double(self, p)

    def xyzz_dadd(self, p1: XyzzPoint, p2: XyzzPoint) -> XyzzPoint:
        return cuda_point.xyzz_dadd(self, p1, p2)

    def xyzz_dadd_affine(self, p1: XyzzPoint, p2: AffinePoint,
                         subtract=None) -> XyzzPoint:
        return cuda_point.xyzz_dadd_affine(self, p1, p2, subtract)

    # ---- plain formula bodies (F: the field ops to run them with) -------------
    def xyzz_double_body(self, p: XyzzPoint, F=None) -> XyzzPoint:
        """dbl-2008-s-1 (a=0). Infinity propagates (ZZ3 = V*ZZ = 0)."""
        F = F or self.F
        U = F.double(p.Y)
        V, A = F.mul_many([(U, U), (p.X, p.X)])
        M = F.mul3(A)
        W, S, MM = F.mul_many([(U, V), (p.X, V), (M, M)])
        X3 = F.sub(MM, F.double(S))
        T1, T2, ZZZ3, ZZ3 = F.mul_many(
            [(M, F.sub(S, X3)), (W, p.Y), (p.ZZZ, W), (p.ZZ, V)])
        return XyzzPoint(X3, F.sub(T1, T2), ZZZ3, ZZ3)

    def xyzz_dadd_body(self, p1: XyzzPoint, p2: XyzzPoint,
                       F=None) -> XyzzPoint:
        """add-2008-s with case analysis: P == Q doubles, P == -Q gives
        infinity, an infinite operand yields the other. The doubling runs
        only when some lane doubles (the JAX body's cond_dbl)."""
        F = F or self.F
        U1, S1, U2, S2, ZZp, ZZZp = F.mul_many([
            (p1.X, p2.ZZ), (p1.Y, p2.ZZZ), (p2.X, p1.ZZ), (p2.Y, p1.ZZZ),
            (p1.ZZ, p2.ZZ), (p1.ZZZ, p2.ZZZ)])
        Pv = F.sub(U2, U1)
        Rv = F.sub(S2, S1)
        PP, RR = F.mul_many([(Pv, Pv), (Rv, Rv)])
        PPP, Q = F.mul_many([(PP, Pv), (U1, PP)])
        X3 = F.sub(F.sub(RR, PPP), F.double(Q))
        T1, T2, ZZ3, ZZZ3 = F.mul_many(
            [(Rv, F.sub(Q, X3)), (S1, PPP), (ZZp, PP), (ZZZp, PPP)])
        added = XyzzPoint(X3, F.sub(T1, T2), ZZZ3, ZZ3)

        p1_inf = self.xyzz_is_inf(p1)
        p2_inf = self.xyzz_is_inf(p2)
        p_zero = F.is_zero(Pv)
        r_zero = F.is_zero(Rv)
        dbl_mask = p_zero & r_zero & ~p1_inf & ~p2_inf
        out = added
        if dbl_mask.any():
            out = self.select(dbl_mask, self.xyzz_double_body(p1, F), added)
        out = self.select(p_zero & ~r_zero & ~p1_inf & ~p2_inf,
                          self.xyzz_inf(self.bshape(p1.X), p1.X.device), out)
        out = self.select(p2_inf, p1, out)
        return self.select(p1_inf, p2, out)

    def xyzz_dadd_affine_body(self, p1: XyzzPoint, p2: AffinePoint,
                              subtract=None, F=None) -> XyzzPoint:
        """The MSM hot op: signed madd-2008-s with case analysis; the
        doubling runs only when some lane doubles (cond_dbl)."""
        F = F or self.F
        y2 = p2.Y if subtract is None else F.cneg(p2.Y, subtract)
        P0, R0 = F.mul_many([(p2.X, p1.ZZ), (y2, p1.ZZZ)])
        Pv = F.sub(P0, p1.X)
        Rv = F.sub(R0, p1.Y)
        PP, RR = F.mul_many([(Pv, Pv), (Rv, Rv)])
        PPP, Q = F.mul_many([(PP, Pv), (p1.X, PP)])
        X3 = F.sub(F.sub(RR, PPP), F.double(Q))
        T1, T2, ZZ3, ZZZ3 = F.mul_many(
            [(Rv, F.sub(Q, X3)), (p1.Y, PPP), (p1.ZZ, PP), (p1.ZZZ, PPP)])
        added = XyzzPoint(X3, F.sub(T1, T2), ZZZ3, ZZ3)

        p1_inf = self.xyzz_is_inf(p1)
        p2_inf = self.affine_is_inf(p2)
        p_zero = F.is_zero(Pv)
        r_zero = F.is_zero(Rv)
        dbl_mask = p_zero & r_zero & ~p1_inf & ~p2_inf
        out = added
        if dbl_mask.any():
            U = F.double(y2)
            V, A = F.mul_many([(U, U), (p2.X, p2.X)])
            M = F.mul3(A)
            W, S, MM = F.mul_many([(U, V), (p2.X, V), (M, M)])
            Xd = F.sub(MM, F.double(S))
            T3, T4 = F.mul_many([(M, F.sub(S, Xd)), (W, y2)])
            out = self.select(dbl_mask, XyzzPoint(Xd, F.sub(T3, T4), W, V),
                              added)
        out = self.select(p_zero & ~r_zero & ~p1_inf & ~p2_inf,
                          self.xyzz_inf(self.bshape(p1.X), p1.X.device), out)
        out = self.select(p1_inf, self.xyzz_from_affine(p2, negate=subtract),
                          out)
        return self.select(p2_inf, p1, out)

    # ---- conversions ------------------------------------------------------------
    def xyzz_to_jac(self, p: XyzzPoint) -> JacPoint:
        F = self.F
        inf = self.xyzz_is_inf(p)
        jac = JacPoint(F.mul(p.X, p.ZZ), F.mul(p.Y, p.ZZZ), p.ZZ)
        return self.select(inf, self.jac_inf(self.bshape(p.X), p.X.device),
                           jac)

    def jac_to_affine(self, p: JacPoint) -> AffinePoint:
        """Batched: one field inversion total. Infinity maps to (0, 0)."""
        F = self.F
        zinv = F.batch_inv(p.Z)
        zinv2 = F.sqr(zinv)
        return AffinePoint(F.mul(p.X, zinv2), F.mul(p.Y, F.mul(zinv2, zinv)))

    def xyzz_to_affine(self, p: XyzzPoint) -> AffinePoint:
        """Batched: one field inversion of ZZ and ZZZ together. Infinity
        maps to (0, 0)."""
        F = self.F
        B = p.ZZ.shape[-1]
        inv = F.batch_inv(torch.cat([p.ZZ, p.ZZZ], dim=-1))
        return AffinePoint(F.mul(p.X, inv[..., :B]), F.mul(p.Y, inv[..., B:]))

    # ---- layout utilities -----------------------------------------------------------
    def concat(self, ps):
        """Like-typed point batches joined along the batch (last) axis."""
        return type(ps[0])(*(torch.cat(cs, dim=-1) for cs in zip(*ps)))

    def tree_reduce_xyzz(self, p: XyzzPoint) -> XyzzPoint:
        """Sum all lanes with log-depth pairwise dadds -> batch of 1: one
        xyzz_dadd (one K2 launch on the card) a level, an odd lane carried
        to the next level."""
        n = p.X.shape[-1]
        while n > 1:
            half = n // 2
            lo = type(p)(*(c[..., :half] for c in p))
            hi = type(p)(*(c[..., half:2 * half] for c in p))
            rest = type(p)(*(c[..., 2 * half:n] for c in p))
            p = self.concat([self.xyzz_dadd(lo, hi), rest])
            n = half + (n - 2 * half)
        return p

    def take(self, p, idx):
        """Gather along the batch (last) axis; a PackedRows32 table gathers
        rows and returns an AffinePoint batch."""
        if isinstance(p, PackedRows32):
            return self.from_rows(PackedRows32(p.XY.index_select(0, idx)))
        return type(p)(*(c.index_select(-1, idx) for c in p))

    def to_rows32(self, p: AffinePoint) -> PackedRows32:
        """(*F.lead, N) affine batch -> (N, 2W) row table."""
        W = self.F.n_words
        return PackedRows32(torch.cat(
            [p.X.reshape(W, -1).T, p.Y.reshape(W, -1).T], dim=1).contiguous())

    def from_rows(self, rows: PackedRows32) -> AffinePoint:
        W = self.F.n_words
        return AffinePoint(*(self.from_words(x.T)
                             for x in (rows.XY[:, :W], rows.XY[:, W:])))

    def from_words(self, x: torch.Tensor) -> torch.Tensor:
        """(W, *batch) words of one coordinate -> (*F.lead, *batch),
        contiguous."""
        return x.reshape(self.F.lead + tuple(x.shape[1:])).contiguous()

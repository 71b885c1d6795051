"""Pure-Python short-Weierstrass curve arithmetic for BLS12-381 G1/G2.

Copy of msm_blst_tpu/refimpl/curve.py for the port: Jacobian and xyzz
coordinates with the full case analysis of the point kernels (add, double,
cancel, either operand at infinity; the reference's ec_ops.h
POINTXYZZ_DADD_AFFINE_IMPL and POINTXYZZ_DADD_IMPL), and the naive MSM.

Infinity conventions (shared with the port's batched curves):
  * affine infinity     = (0, 0)  (not on either curve since b != 0)
  * Jacobian infinity   = Z == 0
  * XYZZ infinity       = ZZ == 0 and ZZZ == 0
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

from .field import Fp, Fp2, Fr
from ..constants import B_G1, B_G2, G1_X, G1_Y, G2_X, G2_Y, R_ORDER


class JacobianPoint(NamedTuple):
    X: object
    Y: object
    Z: object


class XyzzPoint(NamedTuple):
    X: object
    Y: object
    ZZZ: object
    ZZ: object


@dataclass(frozen=True)
class CurveRef:
    """A short-Weierstrass curve y^2 = x^3 + b with a = 0 over field F."""

    F: type
    b: object
    gen_affine: Tuple[object, object]

    # ---- affine helpers -------------------------------------------------
    def affine_is_inf(self, pt) -> bool:
        return pt[0].is_zero() and pt[1].is_zero()

    def affine_inf(self):
        return (self.F.zero(), self.F.zero())

    def is_on_curve(self, pt) -> bool:
        if self.affine_is_inf(pt):
            return True
        x, y = pt
        return y.sqr() == x.sqr() * x + self.b

    # ---- Jacobian -------------------------------------------------------
    def jac_inf(self) -> JacobianPoint:
        return JacobianPoint(self.F.one(), self.F.one(), self.F.zero())

    def jac_is_inf(self, p: JacobianPoint) -> bool:
        return p.Z.is_zero()

    def from_affine(self, pt) -> JacobianPoint:
        if self.affine_is_inf(pt):
            return self.jac_inf()
        return JacobianPoint(pt[0], pt[1], self.F.one())

    def to_affine(self, p: JacobianPoint):
        if self.jac_is_inf(p):
            return self.affine_inf()
        zi = p.Z.inv()
        zi2 = zi.sqr()
        return (p.X * zi2, p.Y * zi2 * zi)

    def jac_double(self, p: JacobianPoint) -> JacobianPoint:
        """dbl-2009-l (a = 0): 2M + 5S."""
        if self.jac_is_inf(p):
            return p
        A = p.X.sqr()
        Bv = p.Y.sqr()
        C = Bv.sqr()
        D = ((p.X + Bv).sqr() - A - C).mul_small(2)
        E = A.mul_small(3)
        F_ = E.sqr()
        X3 = F_ - D.mul_small(2)
        Y3 = E * (D - X3) - C.mul_small(8)
        Z3 = (p.Y * p.Z).mul_small(2)
        return JacobianPoint(X3, Y3, Z3)

    def jac_add(self, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
        """Unified add-or-double ('dadd')."""
        if self.jac_is_inf(p):
            return q
        if self.jac_is_inf(q):
            return p
        Z1Z1 = p.Z.sqr()
        Z2Z2 = q.Z.sqr()
        U1 = p.X * Z2Z2
        U2 = q.X * Z1Z1
        S1 = p.Y * Z2Z2 * q.Z
        S2 = q.Y * Z1Z1 * p.Z
        if U1 == U2:
            if S1 == S2:
                return self.jac_double(p)
            return self.jac_inf()
        H = U2 - U1
        Rr = S2 - S1
        H2 = H.sqr()
        H3 = H2 * H
        V = U1 * H2
        X3 = Rr.sqr() - H3 - V.mul_small(2)
        Y3 = Rr * (V - X3) - S1 * H3
        Z3 = p.Z * q.Z * H
        return JacobianPoint(X3, Y3, Z3)

    def jac_mult(self, scalar: int, p: JacobianPoint) -> JacobianPoint:
        ret = self.jac_inf()
        add = p
        s = scalar
        while s > 0:
            if s & 1:
                ret = self.jac_add(ret, add)
            add = self.jac_double(add)
            s >>= 1
        return ret

    def affine_mult(self, scalar: int, pt):
        return self.to_affine(self.jac_mult(scalar, self.from_affine(pt)))

    # ---- XYZZ -----------------------------------------------------------
    def xyzz_inf(self) -> XyzzPoint:
        z = self.F.zero()
        return XyzzPoint(z, z, z, z)

    def xyzz_is_inf(self, p: XyzzPoint) -> bool:
        return p.ZZZ.is_zero() and p.ZZ.is_zero()

    def xyzz_from_affine(self, pt, negate: bool = False) -> XyzzPoint:
        if self.affine_is_inf(pt):
            return self.xyzz_inf()
        y = -pt[1] if negate else pt[1]
        return XyzzPoint(pt[0], y, self.F.one(), self.F.one())

    def xyzz_to_jacobian(self, p: XyzzPoint) -> JacobianPoint:
        if self.xyzz_is_inf(p):
            return self.jac_inf()
        return JacobianPoint(p.X * p.ZZ, p.Y * p.ZZZ, p.ZZ)

    def xyzz_to_affine(self, p: XyzzPoint):
        if self.xyzz_is_inf(p):
            return self.affine_inf()
        return (p.X * p.ZZ.inv(), p.Y * p.ZZZ.inv())

    def xyzz_double(self, p: XyzzPoint) -> XyzzPoint:
        """dbl-2008-s-1 for XYZZ (a = 0)."""
        if self.xyzz_is_inf(p):
            return p
        U = p.Y.mul_small(2)
        V = U.sqr()
        W = U * V
        S = p.X * V
        M = p.X.sqr().mul_small(3)
        X3 = M.sqr() - S.mul_small(2)
        Y3 = M * (S - X3) - W * p.Y
        return XyzzPoint(X3, Y3, p.ZZZ * W, p.ZZ * V)

    def xyzz_dadd(self, p1: XyzzPoint, p2: XyzzPoint) -> XyzzPoint:
        """add-2008-s with the full case analysis (spec: the reference's ec_ops.h)."""
        if self.xyzz_is_inf(p2):
            return p1
        if self.xyzz_is_inf(p1):
            return p2
        U1 = p1.X * p2.ZZ
        S1 = p1.Y * p2.ZZZ
        U2 = p2.X * p1.ZZ
        S2 = p2.Y * p1.ZZZ
        Pv = U2 - U1
        Rv = S2 - S1
        if not Pv.is_zero():
            PP = Pv.sqr()
            PPP = PP * Pv
            Q = U1 * PP
            X3 = Rv.sqr() - PPP - Q.mul_small(2)
            Y3 = Rv * (Q - X3) - S1 * PPP
            return XyzzPoint(X3, Y3, p1.ZZZ * p2.ZZZ * PPP, p1.ZZ * p2.ZZ * PP)
        if Rv.is_zero():
            return self.xyzz_double(p1)
        return self.xyzz_inf()

    def xyzz_dadd_affine(self, p1: XyzzPoint, p2, subtract: bool = False) -> XyzzPoint:
        """madd-2008-s with sign; spec: the reference's ec_ops.h. p2 is affine."""
        if self.affine_is_inf(p2):
            return p1
        x2, y2 = p2
        if subtract:
            y2 = -y2
        if self.xyzz_is_inf(p1):
            return XyzzPoint(x2, y2, self.F.one(), self.F.one())
        Pv = x2 * p1.ZZ - p1.X
        Rv = y2 * p1.ZZZ - p1.Y
        if not Pv.is_zero():
            PP = Pv.sqr()
            PPP = PP * Pv
            Q = p1.X * PP
            X3 = Rv.sqr() - PPP - Q.mul_small(2)
            Y3 = Rv * (Q - X3) - p1.Y * PPP
            return XyzzPoint(X3, Y3, p1.ZZZ * PPP, p1.ZZ * PP)
        if Rv.is_zero():
            # double the affine point (mdbl-2008-s-1)
            U = y2.mul_small(2)
            V = U.sqr()
            W = U * V
            S = x2 * V
            M = x2.sqr().mul_small(3)
            X3 = M.sqr() - S.mul_small(2)
            Y3 = M * (S - X3) - W * y2
            return XyzzPoint(X3, Y3, W, V)
        return self.xyzz_inf()

    # ---- MSM oracle ------------------------------------------------------
    def naive_msm(self, scalars: Sequence[int], points: Sequence):
        """Sum_i scalars[i] * points[i], affine in/out. The MSM ground truth."""
        acc = self.jac_inf()
        for s, pt in zip(scalars, points):
            acc = self.jac_add(acc, self.jac_mult(s % R_ORDER, self.from_affine(pt)))
        return self.to_affine(acc)

    def generator_jac(self) -> JacobianPoint:
        return self.from_affine(self.gen_affine)

    def fixed_points(self, n: int):
        """P_i = 2^(i+1) * G, i = 0..n-1 (the reference's main_p1.cpp)."""
        pts = []
        cur = self.jac_double(self.generator_jac())
        for _ in range(n):
            pts.append(self.to_affine(cur))
            cur = self.jac_double(cur)
        return pts


G1_REF = CurveRef(F=Fp, b=Fp(B_G1), gen_affine=(Fp(G1_X), Fp(G1_Y)))
G2_REF = CurveRef(F=Fp2, b=Fp2(*B_G2), gen_affine=(Fp2(*G2_X), Fp2(*G2_Y)))

"""Fp6 / Fp12 extension tower for BLS12-381 (pure Python, exact arithmetic).

Copy of msm_blst_tpu/protocol/tower.py for the port. Capability twin of
blst's tower (src/fp12_tower.c):
    Fp2  = Fp[u] / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Used by the pairing (protocol/pairing.py) and the G2 psi endomorphism
(protocol/glv.py). Frobenius coefficients are *derived at import time* from
the tower definition (xi^((p-1)/6) powers) rather than transcribed, so they
are correct by construction.
"""

from __future__ import annotations

from ..constants import P
from ..refimpl.field import Fp, Fp2

XI = Fp2(1, 1)  # the Fp6 non-residue v^3 = 1 + u


def _fp2_pow(a: Fp2, e: int) -> Fp2:
    r = Fp2.one()
    b = a
    while e:
        if e & 1:
            r = r * b
        b = b.sqr()
        e >>= 1
    return r


def fp2_conj(a: Fp2) -> Fp2:
    """Frobenius on Fp2: (c0 + c1 u)^p = c0 - c1 u  (since p = 3 mod 4)."""
    return Fp2(a.c0, -a.c1)


def fp2_mul_by_xi(a: Fp2) -> Fp2:
    """a * (1 + u): one add/sub pair, no multiply."""
    return Fp2(a.c0 - a.c1, a.c0 + a.c1)


# gamma_k = xi^(k (p-1)/6): coefficient of the p-power Frobenius acting on
# the basis element v^j w^i  (v = w^2 -> exponent k = 2j + i).
assert (P - 1) % 6 == 0
_G = [_fp2_pow(XI, k * (P - 1) // 6) for k in range(6)]


class Fp6:
    """c0 + c1 v + c2 v^2, components in Fp2, v^3 = xi."""

    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @classmethod
    def zero(cls):
        return cls(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @classmethod
    def one(cls):
        return cls(Fp2.one(), Fp2.zero(), Fp2.zero())

    def is_zero(self):
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, o):
        return (
            isinstance(o, Fp6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def __add__(self, o):
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o):
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self):
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o):
        """Toom/Karatsuba-style interpolation (6 Fp2 muls), as fp12_tower.c."""
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = fp2_mul_by_xi((a1 + a2) * (b1 + b2) - t1 - t2) + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + fp2_mul_by_xi(t2)
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def mul_fp2(self, k: Fp2):
        return Fp6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self):
        """Multiply by v: (c0, c1, c2) -> (xi c2, c0, c1)."""
        return Fp6(fp2_mul_by_xi(self.c2), self.c0, self.c1)

    def sqr(self):
        return self * self

    def inv(self):
        """Standard cubic-extension inverse via the norm."""
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.sqr() - fp2_mul_by_xi(a1 * a2)
        t1 = fp2_mul_by_xi(a2.sqr()) - a0 * a1
        t2 = a1.sqr() - a0 * a2
        norm = a0 * t0 + fp2_mul_by_xi(a2 * t1 + a1 * t2)
        ni = norm.inv()
        return Fp6(t0 * ni, t1 * ni, t2 * ni)


class Fp12:
    """a0 + a1 w, components in Fp6, w^2 = v."""

    __slots__ = ("a0", "a1")

    def __init__(self, a0: Fp6, a1: Fp6):
        self.a0, self.a1 = a0, a1

    @classmethod
    def zero(cls):
        return cls(Fp6.zero(), Fp6.zero())

    @classmethod
    def one(cls):
        return cls(Fp6.one(), Fp6.zero())

    def is_zero(self):
        return self.a0.is_zero() and self.a1.is_zero()

    def is_one(self):
        return self == Fp12.one()

    def __eq__(self, o):
        return isinstance(o, Fp12) and self.a0 == o.a0 and self.a1 == o.a1

    def __add__(self, o):
        return Fp12(self.a0 + o.a0, self.a1 + o.a1)

    def __sub__(self, o):
        return Fp12(self.a0 - o.a0, self.a1 - o.a1)

    def __neg__(self):
        return Fp12(-self.a0, -self.a1)

    def __mul__(self, o):
        """Karatsuba over the quadratic step (3 Fp6 muls)."""
        t0 = self.a0 * o.a0
        t1 = self.a1 * o.a1
        t2 = (self.a0 + self.a1) * (o.a0 + o.a1)
        return Fp12(t0 + t1.mul_by_v(), t2 - t0 - t1)

    def sqr(self):
        """Complex squaring: (a0 + a1 w)^2 with w^2 = v (2 Fp6 muls)."""
        t = self.a0 * self.a1
        c0 = (self.a0 + self.a1) * (self.a0 + self.a1.mul_by_v()) - t - t.mul_by_v()
        return Fp12(c0, t + t)

    def conj(self):
        """The p^6-power Frobenius: a0 - a1 w (w^(p^6) = -w)."""
        return Fp12(self.a0, -self.a1)

    def inv(self):
        norm = self.a0.sqr() - self.a1.sqr().mul_by_v()
        ni = norm.inv()
        return Fp12(self.a0 * ni, -(self.a1 * ni))

    def frobenius(self):
        """The p-power Frobenius map (coefficients derived at import)."""
        a0, a1 = self.a0, self.a1
        # basis v^j w^i: exponent of the gamma table is 2j + i
        return Fp12(
            Fp6(
                fp2_conj(a0.c0),
                fp2_conj(a0.c1) * _G[2],
                fp2_conj(a0.c2) * _G[4],
            ),
            Fp6(
                fp2_conj(a1.c0) * _G[1],
                fp2_conj(a1.c1) * _G[3],
                fp2_conj(a1.c2) * _G[5],
            ),
        )

    def frobenius_n(self, n: int):
        r = self
        for _ in range(n % 12):
            r = r.frobenius()
        return r

    def pow_int(self, e: int):
        if e < 0:
            return self.inv().pow_int(-e)
        r = Fp12.one()
        b = self
        while e:
            if e & 1:
                r = r * b
            b = b.sqr()
            e >>= 1
        return r

    def cyclotomic_sqr(self):
        """Granger-Scott squaring, valid in the cyclotomic subgroup only
        (capability twin of cyclotomic_sqr_fp12 in fp12_tower.c). Validated
        against generic sqr() in tests on post-easy-part elements."""
        a0, a1 = self.a0, self.a1
        z0, z4, z3 = a0.c0, a0.c1, a0.c2
        z2, z1, z5 = a1.c0, a1.c1, a1.c2

        def fp4_sqr(c0: Fp2, c1: Fp2):
            t0 = c0.sqr()
            t1 = c1.sqr()
            return t0 + fp2_mul_by_xi(t1), (c0 + c1).sqr() - t0 - t1

        t0, t1 = fp4_sqr(z0, z1)
        z0 = (t0 - z0).mul_small(2) + t0
        z1 = (t1 + z1).mul_small(2) + t1
        t0, t1 = fp4_sqr(z2, z3)
        t2, t3 = fp4_sqr(z4, z5)
        z4 = (t0 - z4).mul_small(2) + t0
        z5 = (t1 + z5).mul_small(2) + t1
        t0 = fp2_mul_by_xi(t3)
        z2 = (t0 + z2).mul_small(2) + t0
        z3 = (t2 - z3).mul_small(2) + t2
        return Fp12(Fp6(z0, z4, z3), Fp6(z2, z1, z5))

    def __repr__(self):
        return f"Fp12({self.a0.c0}, ...)"

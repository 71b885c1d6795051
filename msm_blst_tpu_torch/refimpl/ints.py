"""Pure-Python G1 and G2 arithmetic over ints: the port's host oracle.

`G1` works over Fp (an int), `G2` over Fp2 = Fp[i]/(i^2 + 1) (an int pair
(c0, c1) for c0 + c1*i). Affine points are (x, y) pairs with infinity
(INF: both coordinates zero), the convention of the rest of the package.
Slow and plainly correct: it builds the fixed-base window tables
(msm/precompute.py) and checks MSM results (chip_smoke.py). The tests hold
it equal to msm_blst_tpu.refimpl.G1_REF and G2_REF
(tests/test_torch_fields.py, tests/test_torch_fp2.py).
"""

from __future__ import annotations

from ..constants import B_G1, B_G2, G1_X, G1_Y, G2_X, G2_Y, P, R_ORDER


class _Fp:
    """Fp on ints mod P."""

    zero = 0

    @staticmethod
    def add(a, b):
        return (a + b) % P

    @staticmethod
    def sub(a, b):
        return (a - b) % P

    @staticmethod
    def mul(a, b):
        return a * b % P

    @staticmethod
    def small(k: int):
        return k % P

    @staticmethod
    def inv(a):
        return pow(a, -1, P)


class _Fp2:
    """Fp2 on (c0, c1) int pairs, i^2 = -1."""

    zero = (0, 0)

    @staticmethod
    def add(a, b):
        return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)

    @staticmethod
    def sub(a, b):
        return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)

    @staticmethod
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P,
                (a[0] * b[1] + a[1] * b[0]) % P)

    @staticmethod
    def small(k: int):
        return (k % P, 0)

    @staticmethod
    def inv(a):
        """(a0 - a1 i) / (a0^2 + a1^2)."""
        ninv = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
        return (a[0] * ninv % P, -a[1] * ninv % P)


class Curve:
    """y^2 = x^3 + b over the field F, affine, a = 0."""

    def __init__(self, F, b, generator):
        self.F = F
        self.b = b
        self.INF = (F.zero, F.zero)
        self.GENERATOR = generator

    def is_on_curve(self, pt) -> bool:
        F = self.F
        x, y = pt
        return pt == self.INF or F.sub(F.mul(y, y), F.add(
            F.mul(F.mul(x, x), x), self.b)) == F.zero

    def add(self, p1, p2):
        """p1 + p2 in affine, with the doubling and cancelling cases."""
        F = self.F
        if p1 == self.INF:
            return p2
        if p2 == self.INF:
            return p1
        (x1, y1), (x2, y2) = p1, p2
        if x1 == x2:
            if F.add(y1, y2) == F.zero:
                return self.INF
            lam = F.mul(F.mul(F.small(3), F.mul(x1, x1)),
                        F.inv(F.add(y1, y1)))
        else:
            lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.mul(lam, lam), x1), x2)
        return x3, F.sub(F.mul(lam, F.sub(x1, x3)), y1)

    def mult(self, k: int, pt=None):
        """k * pt (default: the generator) by double-and-add, k mod r."""
        pt = self.GENERATOR if pt is None else pt
        acc = self.INF
        for bit in bin(k % R_ORDER)[2:]:
            acc = self.add(acc, acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc


G1 = Curve(_Fp, B_G1, (G1_X, G1_Y))
G2 = Curve(_Fp2, tuple(B_G2), (tuple(G2_X), tuple(G2_Y)))
CURVES = {"G1": G1, "G2": G2}

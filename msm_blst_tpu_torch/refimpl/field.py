"""Pure-Python field elements: Fp, Fp2 (i^2 = -1), Fr.

Copy of msm_blst_tpu/refimpl/field.py for the port. All arithmetic is
canonical (no Montgomery form); the host protocol stack (protocol/)
computes with these classes.
"""

from __future__ import annotations

from ..constants import P, R_ORDER


class _PrimeField:
    """Element of a prime field; subclasses set MODULUS."""

    MODULUS: int = 0
    __slots__ = ("v",)

    def __init__(self, v: int):
        self.v = v % self.MODULUS

    def __add__(self, o):
        return type(self)(self.v + o.v)

    def __sub__(self, o):
        return type(self)(self.v - o.v)

    def __mul__(self, o):
        return type(self)(self.v * o.v)

    def __neg__(self):
        return type(self)(-self.v)

    def __eq__(self, o):
        return isinstance(o, type(self)) and self.v == o.v

    def __hash__(self):
        return hash((type(self).__name__, self.v))

    def __repr__(self):
        return f"{type(self).__name__}(0x{self.v:x})"

    def is_zero(self) -> bool:
        return self.v == 0

    def inv(self):
        if self.v == 0:
            raise ZeroDivisionError("field inverse of zero")
        return type(self)(pow(self.v, self.MODULUS - 2, self.MODULUS))

    def sqr(self):
        return self * self

    def mul_small(self, k: int):
        return type(self)(self.v * k)

    @classmethod
    def zero(cls):
        return cls(0)

    @classmethod
    def one(cls):
        return cls(1)


class Fp(_PrimeField):
    MODULUS = P


class Fr(_PrimeField):
    MODULUS = R_ORDER


class Fp2:
    """a0 + a1*i with i^2 = -1, components in Fp."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0, c1):
        self.c0 = c0 if isinstance(c0, Fp) else Fp(c0)
        self.c1 = c1 if isinstance(c1, Fp) else Fp(c1)

    def __add__(self, o):
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o):
        # Karatsuba: (a0 b0 - a1 b1) + ((a0+a1)(b0+b1) - a0 b0 - a1 b1) i
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2(t0 - t1, t2 - t0 - t1)

    def __neg__(self):
        return Fp2(-self.c0, -self.c1)

    def __eq__(self, o):
        return isinstance(o, Fp2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0.v, self.c1.v))

    def __repr__(self):
        return f"Fp2(0x{self.c0.v:x}, 0x{self.c1.v:x})"

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def sqr(self):
        # (a0+a1)(a0-a1) + (2 a0 a1) i
        return Fp2((self.c0 + self.c1) * (self.c0 - self.c1), (self.c0 * self.c1).mul_small(2))

    def inv(self):
        # 1/(a0 + a1 i) = (a0 - a1 i) / (a0^2 + a1^2)
        norm = self.c0 * self.c0 + self.c1 * self.c1
        ninv = norm.inv()
        return Fp2(self.c0 * ninv, -(self.c1 * ninv))

    def mul_small(self, k: int):
        return Fp2(self.c0.mul_small(k), self.c1.mul_small(k))

    @classmethod
    def zero(cls):
        return cls(0, 0)

    @classmethod
    def one(cls):
        return cls(1, 0)

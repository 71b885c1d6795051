"""Fp2 = Fp[i]/(i^2 + 1) over the port's Fp word batches.

Port of msm_blst_tpu/fields/fp2.py. An element batch is `int32[2, 12,
*batch]`: the component axis in front (c0 + c1*i), then the twelve words of
each component, batch last, so every Fp operation, the K1 multiply
included, runs unchanged on a component. The contiguous tensor is the
column layout the G2 kernels read: component c, word k of element i at
(c*12 + k)*B + i.

`mul_many` is Karatsuba with ONE base-field `mul_many` over all 3k
products, so on the card a batch of Fp2 products is one K1 launch. The
additions around it, and `add`, `sub` and `neg`, run the base field once
over both components (and all pairs) side by side, as an int32[12, 2, ...]
batch: one set of tensor ops where a component at a time would take two.
Every component stays canonical, so any correct product gives the JAX
package's words. The base field's `mul_impl` picks the kernel those
products run on (K1 or K6); `fp2_for` gives the Fp2 over either.
"""

from __future__ import annotations

import functools

import torch

from .limb import FP, LimbField, fp_for


class Fp2Ops:
    """The field-ops protocol of LimbField, over Fp2 elements."""

    def __init__(self, base: LimbField):
        self.base = base
        self.kernels = base.kernels
        self.mul_impl = base.mul_impl
        self.lead = (2,) + base.lead  # axes in front of the batch
        self.n_words = 2 * base.n_words  # words of one element, c0 then c1

    @functools.cached_property
    def plain(self) -> "Fp2Ops":
        if not self.kernels:
            return self
        return Fp2Ops(self.base.plain)

    # ---- construction ----------------------------------------------------------
    @staticmethod
    def build(c0, c1):
        return torch.stack([c0, c1])

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros(self.lead + tuple(batch_shape), dtype=torch.int32,
                           device=device)

    def one_mont(self, batch_shape=(), device=None) -> torch.Tensor:
        return self.build(self.base.one_mont(batch_shape, device),
                          self.base.zeros(batch_shape, device))

    # ---- predicates ------------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(dim=0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0).all(dim=0)

    def select(self, mask, a, b):
        """mask ? a : b, mask shaped like the batch (broadcast from the
        right over the component and word axes)."""
        return torch.where(mask, a, b)

    # ---- arithmetic ------------------------------------------------------------
    @staticmethod
    def _both(fn, *xs):
        """A base-field op on both components at once: (2, 12, *b) elements
        as one (12, 2, *b) batch."""
        return fn(*(x.movedim(0, 1) for x in xs)).movedim(1, 0)

    def add(self, a, b):
        return self._both(self.base.add, a, b)

    def sub(self, a, b):
        return self._both(self.base.sub, a, b)

    def double(self, a):
        return self.add(a, a)

    def mul3(self, a):
        return self.add(self.double(a), a)

    def mul8(self, a):
        return self.double(self.double(self.double(a)))

    def neg(self, a):
        return self._both(self.base.neg, a)

    def cneg(self, a, flag):
        return self.select(flag, self.neg(a), a)

    def mul(self, a, b):
        return self.mul_many([(a, b)])[0]

    def sqr(self, a):
        """(a0 + a1)(a0 - a1) + (2 a0 a1) i, both products in one call."""
        F = self.base
        c0, c1h = F.mul_many([(F.add(a[0], a[1]), F.sub(a[0], a[1])),
                              (a[0], a[1])])
        return self.build(c0, F.double(c1h))

    def mul_many(self, pairs):
        """Karatsuba over all pairs with one base-field multiply call:
        (a0 b0 - a1 b1) + ((a0 + a1)(b0 + b1) - a0 b0 - a1 b1) i. The pairs
        share one shape; the k pairs ride a base-field batch axis."""
        F = self.base
        k = len(pairs)
        a = torch.stack([p[0] for p in pairs], dim=2)  # (2, 12, k, *batch)
        b = torch.stack([p[1] for p in pairs], dim=2)
        sums = F.add(torch.cat([a[0], b[0]], dim=1),
                     torch.cat([a[1], b[1]], dim=1))  # a0 + a1 || b0 + b1
        t0, t1, t2 = F.mul_many([(a[0], b[0]), (a[1], b[1]),
                                 (sums[:, :k], sums[:, k:])])
        d = F.sub(torch.cat([t0, t2], dim=1), torch.cat([t1, t0], dim=1))
        c0, c1 = d[:, :k], F.sub(d[:, k:], t1)  # t0 - t1, t2 - t0 - t1
        return [self.build(c0[:, i], c1[:, i]) for i in range(k)]

    def _over_norm(self, a, ninv_fn):
        """(a0 - a1 i) * ninv_fn(a0^2 + a1^2); 0 maps to 0."""
        F = self.base
        s0, s1 = F.mul_many([(a[0], a[0]), (a[1], a[1])])
        ninv = ninv_fn(F.add(s0, s1))
        r0, r1 = F.mul_many([(a[0], ninv), (a[1], ninv)])
        return self.build(r0, F.neg(r1))

    def inv(self, a):
        return self._over_norm(a, self.base.inv)

    def batch_inv(self, a):
        """Elementwise inverse over the last axis: one base-field batch
        inversion of the norms."""
        return self._over_norm(a, self.base.batch_inv)

    def pow_int(self, a, e: int):
        """a^e for a static exponent (Montgomery domain in and out): a
        square for every bit of e and a product for every set bit, each one
        base-field multiply call."""
        acc = self.one_mont(a.shape[2:], a.device)
        for bit in bin(e)[2:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    # ---- host io ---------------------------------------------------------------
    def from_int_pairs(self, pairs, mont: bool = True, device=None):
        """[(c0, c1) ints] -> batch (Montgomery form by default) on `device`
        (default: the card)."""
        pairs = list(pairs)
        return self.build(
            self.base.from_ints([p[0] for p in pairs], mont=mont, device=device),
            self.base.from_ints([p[1] for p in pairs], mont=mont, device=device))

    def to_int_pairs(self, a, mont: bool = True) -> list:
        return list(zip(self.base.to_ints(a[0], mont=mont),
                        self.base.to_ints(a[1], mont=mont)))


FP2 = Fp2Ops(FP)


@functools.lru_cache(maxsize=None)
def fp2_for(mul_impl: str = "cios") -> Fp2Ops:
    """Fp2 over the base field whose multiply is `mul_impl` (FP2 for
    "cios")."""
    return FP2 if mul_impl == "cios" else Fp2Ops(fp_for(mul_impl))

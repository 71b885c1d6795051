"""Montgomery field arithmetic on 32-bit words, in PyTorch.

Port of msm_blst_tpu/fields/limb.py. Layout:

* An Fp batch is `int32[12, *batch]`: twelve little-endian 32-bit words,
  words first and batch last. These are the bits of a JAX PackedRows32 row
  (curves/ops.py pack_u16_rows puts 16-bit limb 2k in the low half of word
  k). The Montgomery radix is R = 2^384 as in the JAX package, so a residue
  here and a JAX `uint32[24, B]` residue are the same number and canonical
  values compare bit for bit (convert.py moves between the two).
* Every value between operations is canonical (< p).
* The plain path computes in `int64` over 16-bit limbs: torch has no usable
  uint32 arithmetic on the CPU, and `>>` on int32 is arithmetic, so words
  are masked into int64 before any shift.

`LimbField.mul` is the one operation with a kernel, chosen per field by the
`mul_impl` keyword (the JAX package's pallas_mont.mul_impl): "cios" (the
default, K1, fields/cuda_mont.py) or "sos" (K6, fields/sos.py). On a CUDA
tensor it launches that kernel, on a CPU tensor it runs the kernel's plain
version; both give the same words. Adds, subtracts and selects are plain
tensor code on either device, as they were XLA code in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import P, R_ORDER
from ..device import resolve

LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1
MUL_IMPLS = ("cios", "sos")


# ---- host conversions -------------------------------------------------------


def int_to_words(x: int, n_words: int) -> np.ndarray:
    """Python int -> int32[n_words] little-endian 32-bit words (two's
    complement bits of the unsigned words)."""
    assert 0 <= x < (1 << (WORD_BITS * n_words))
    u = np.array([(x >> (WORD_BITS * i)) & WORD_MASK for i in range(n_words)],
                 dtype=np.uint32)
    return u.view(np.int32)


def words_to_int(words) -> int:
    w = np.asarray(words).astype(np.int64).reshape(-1) & WORD_MASK
    return sum(int(v) << (WORD_BITS * i) for i, v in enumerate(w))


def ints_to_array(xs, n_words: int) -> np.ndarray:
    """Iterable of ints -> int32[n_words, len(xs)]."""
    xs = list(xs)
    out = np.zeros((n_words, len(xs)), dtype=np.int32)
    for j, x in enumerate(xs):
        out[:, j] = int_to_words(x, n_words)
    return out


def array_to_ints(a) -> list:
    """int32[n_words, batch] (numpy or tensor) -> list of Python ints."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    a = np.asarray(a)
    assert a.ndim == 2
    return [words_to_int(a[:, j]) for j in range(a.shape[1])]


# ---- limb helpers (int64 16-bit limbs, limbs first) ---------------------------


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """int32[W, *b] words -> int64[2W, *b] clean 16-bit limbs."""
    u = w.to(torch.int64) & WORD_MASK
    lo = u & MASK
    hi = u >> LIMB_BITS
    return torch.stack([lo, hi], dim=1).reshape((2 * w.shape[0],) + w.shape[1:])


def limbs_to_words(l: torch.Tensor) -> torch.Tensor:
    """int64[2W, *b] clean 16-bit limbs -> int32[W, *b] words."""
    pairs = l.reshape((l.shape[0] // 2, 2) + l.shape[1:])
    u = pairs[:, 0] | (pairs[:, 1] << LIMB_BITS)
    return (u - ((u >> 31) << WORD_BITS)).to(torch.int32)


def _shift_up(x: torch.Tensor, d: int = 1, fill: int = 0) -> torch.Tensor:
    """Row j of the output = row j-d of x (values move toward higher limbs)."""
    pad = torch.full_like(x[:d], fill)
    return torch.cat([pad, x[:-d]])


def resolve_limbs(s: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Propagate carries: int64[K, ...] non-negative limbs below 2^bits (the
    value sum s[k] 2^(16k)) -> clean 16-bit limbs int64[K+1, ...].

    Requires the value < 2^(16 (K+1)); anything above is dropped, so
    `resolve_limbs(s)[:K]` is the value mod 2^(16K). Local carry passes
    first bring every limb to at most 17 bits; then the single-bit ripple
    is resolved at once: the carry into limb k is the carry out of the last
    limb below k that does not merely propagate (one that generates, or
    one that stops a carry), found with a running maximum of indices."""
    s = torch.cat([s, torch.zeros_like(s[:1])])
    while bits > LIMB_BITS + 1:
        s = (s & MASK) + _shift_up(s >> LIMB_BITS)
        bits = max(bits - LIMB_BITS, LIMB_BITS) + 1
    g = s >> LIMB_BITS
    stops = (g != 0) | ((s & MASK) != MASK)
    K = s.shape[0]
    idx = torch.arange(K, device=s.device).reshape((K,) + (1,) * (s.ndim - 1))
    last = torch.cummax(torch.where(stops, idx, -1), dim=0).values
    src = _shift_up(last, 1, fill=-1)  # the last stop strictly below k
    carry = torch.gather(g, 0, src.clamp(min=0)) * (src >= 0)
    return (s + carry) & MASK


def _limb_array(x: int, n_limbs: int) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(n_limbs)],
                    dtype=np.int64)


class LimbField:
    """Branch-free batched arithmetic mod `modulus` on 32-bit words.

    `mul_impl` picks the multiply: "cios" (K1) or "sos" (K6).
    `kernels=False` gives the plain twin of a field: the same arithmetic
    with every multiply on the plain path, whatever the device. The kernel
    modules compare against it on the card.
    """

    def __init__(self, modulus: int, kernels: bool = True,
                 mul_impl: str = "cios"):
        if mul_impl not in MUL_IMPLS:
            raise ValueError(f"mul_impl must be one of {MUL_IMPLS}, got "
                             f"{mul_impl!r}")
        self.modulus = modulus
        self.mul_impl = mul_impl
        self.n_words = -(-modulus.bit_length() // WORD_BITS)
        self.lead = (self.n_words,)  # axes in front of the batch
        self.n_limbs = 2 * self.n_words
        self.kernels = kernels
        self.R = 1 << (WORD_BITS * self.n_words)
        assert modulus % 2 == 1 and modulus < self.R
        L = self.n_limbs
        self._host = {  # limb constants (int64) and Montgomery one (words)
            "P": _limb_array(modulus, L),
            "NOT_P": _limb_array(self.R - modulus, L),
            "NPRIME": _limb_array((-pow(modulus, -1, self.R)) % self.R, L),
            "ONE_MONT": int_to_words(self.R % modulus, self.n_words),
            "ONE": int_to_words(1, self.n_words),  # from_mont's operand
            "RR": int_to_words(self.R * self.R % modulus, self.n_words),
        }
        self._dev: dict = {}

    @functools.cached_property
    def plain(self) -> "LimbField":
        if not self.kernels:
            return self
        return LimbField(self.modulus, kernels=False, mul_impl=self.mul_impl)

    # ---- constants -----------------------------------------------------------
    def _const(self, name: str, device) -> torch.Tensor:
        """A host constant on `device`, copied there once."""
        key = (name, str(device))
        t = self._dev.get(key)
        if t is None:
            t = torch.as_tensor(self._host[name], device=device)
            self._dev[key] = t
        return t

    def limb_const(self, name: str, device, batch_ndim: int) -> torch.Tensor:
        """int64 limb constant shaped (L, 1, ..., 1) for batch_ndim dims."""
        return self._const(name, device).reshape(
            (self.n_limbs,) + (1,) * batch_ndim)

    def zeros(self, batch_shape=(), device=None) -> torch.Tensor:
        return torch.zeros((self.n_words,) + tuple(batch_shape),
                           dtype=torch.int32, device=device)

    def word_const(self, name: str, device, batch_ndim: int) -> torch.Tensor:
        """int32 word constant shaped (W, 1, ..., 1) for batch_ndim dims."""
        return self._const(name, device).reshape(
            (self.n_words,) + (1,) * batch_ndim)

    def one_mont(self, batch_shape=(), device=None) -> torch.Tensor:
        """Montgomery-domain 1 (= R mod p), broadcast over batch_shape."""
        shape = tuple(batch_shape)
        return self.word_const("ONE_MONT", device, len(shape)).expand(
            (self.n_words,) + shape).contiguous()

    # ---- predicates ----------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    def select(self, mask, a, b):
        """mask ? a : b, mask shaped like the batch."""
        return torch.where(mask, a, b)

    # ---- limb-level add / sub (int64 limbs in, int64 limbs out) ----------------
    def csub_p_limbs(self, r):
        """Clean limbs r < 2p -> r mod p."""
        L = self.n_limbs
        v = resolve_limbs(r + self.limb_const("NOT_P", r.device, r.ndim - 1),
                          bits=LIMB_BITS + 1)
        return torch.where(v[L] != 0, v[:L], r)

    def add_limbs(self, a, b):
        s = resolve_limbs(a + b, bits=LIMB_BITS + 1)[: self.n_limbs]
        return self.csub_p_limbs(s)

    def sub_limbs(self, a, b):
        # a - b via a + (2^(16L) - b), then + p if a < b
        L = self.n_limbs
        s = a + (MASK - b)
        s = torch.cat([s[:1] + 1, s[1:]])
        r = resolve_limbs(s, bits=LIMB_BITS + 1)
        a_ge_b = r[L] != 0
        r = r[:L]
        r_plus_p = resolve_limbs(
            r + self.limb_const("P", r.device, r.ndim - 1),
            bits=LIMB_BITS + 1)[:L]
        return torch.where(a_ge_b, r, r_plus_p)

    # ---- add / sub on words ------------------------------------------------------
    def add(self, a, b):
        return limbs_to_words(self.add_limbs(words_to_limbs(a),
                                             words_to_limbs(b)))

    def double(self, a):
        return self.add(a, a)

    def sub(self, a, b):
        return limbs_to_words(self.sub_limbs(words_to_limbs(a),
                                             words_to_limbs(b)))

    def neg(self, a):
        """-a mod p (0 -> 0)."""
        return self.sub(torch.zeros_like(a), a)

    def cneg(self, a, flag):
        """flag ? -a : a."""
        return self.select(flag, self.neg(a), a)

    def mul3(self, a):
        return self.add(self.add(a, a), a)

    def mul8(self, a):
        return self.double(self.double(self.double(a)))

    # ---- Montgomery multiply -----------------------------------------------------
    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p: K1 (fields/cuda_mont.py) or K6
        (fields/sos.py), by `mul_impl`."""
        from . import cuda_mont, sos

        W = self.n_words
        if a.shape != b.shape:  # e.g. (W, 1) constants against (W, B)
            shp = torch.broadcast_shapes(a.shape, b.shape)
            a = a.expand(shp)
            b = b.expand(shp)
        batch = a.shape[1:]
        a2 = a.reshape(W, -1).contiguous()
        b2 = b.reshape(W, -1).contiguous()
        if self.mul_impl == "sos":
            fn = sos.sos_mul if self.kernels else sos.sos_mul_plain
        else:
            fn = cuda_mont.mont_mul if self.kernels else cuda_mont.mont_mul_plain
        r = fn(a2, b2, self)
        return r.reshape((W,) + tuple(batch))

    def sqr(self, a):
        return self.mul(a, a)

    def mul_many(self, pairs):
        """Many independent products in ONE multiply call, stacked along the
        batch axis (all pairs share a shape)."""
        if len(pairs) == 1:
            return [self.mul(pairs[0][0], pairs[0][1])]
        a = torch.cat([p[0] for p in pairs], dim=-1)
        b = torch.cat([p[1] for p in pairs], dim=-1)
        return list(torch.chunk(self.mul(a, b), len(pairs), dim=-1))

    # ---- Montgomery domain conversions ------------------------------------------
    def to_mont(self, a):
        """a*R mod p: one product by R^2 (one multiply launch)."""
        return self.mul(a, self.word_const("RR", a.device, a.ndim - 1))

    def from_mont(self, a):
        """a*R^-1 mod p: one product by 1 (one multiply launch)."""
        return self.mul(a, self.word_const("ONE", a.device, a.ndim - 1))

    # ---- exponentiation / inversion ----------------------------------------------
    def pow_int(self, a, e: int):
        """a^e for a static exponent (Montgomery domain in and out)."""
        acc = self.one_mont(a.shape[1:], a.device)
        for bit in bin(e)[2:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """a^-1 via Fermat; inv(0) = 0."""
        return self.pow_int(a, self.modulus - 2)

    def is_square(self, a):
        """bool batch: True where a is a square mod p, zero included (Euler's
        criterion a^((p-1)/2) == 1)."""
        e = self.pow_int(a, (self.modulus - 1) >> 1)
        return self.eq(e, self.one_mont(a.shape[1:], a.device)) | self.is_zero(a)

    def batch_inv(self, a):
        """Elementwise inverse over the last axis via Montgomery's trick: two
        product scans and one Fermat inversion. Zeros pass through as zeros."""
        from ..utils import scans

        zero_mask = self.is_zero(a)
        one = self.one_mont(a.shape[1:], a.device)
        safe = torch.where(zero_mask, one, a)
        pref = scans.prefix_scan(self.mul, safe)
        suf = scans.suffix_scan(self.mul, safe)
        inv_total = self.pow_int(pref[..., -1:], self.modulus - 2)
        one1 = self.one_mont(a.shape[1:-1] + (1,), a.device)
        left = torch.cat([one1, pref[..., :-1]], dim=-1)
        right = torch.cat([suf[..., 1:], one1], dim=-1)
        inv = self.mul(self.mul(left, right), inv_total.expand(a.shape))
        return torch.where(zero_mask, torch.zeros_like(a), inv)

    # ---- host io -------------------------------------------------------------------
    def from_ints(self, xs, mont: bool = True, device=None) -> torch.Tensor:
        """Host ints -> batch, canonicalised mod p (optionally Montgomery),
        on `device` (default: the card, device.default_device)."""
        vals = [x % self.modulus for x in xs]
        if mont:
            vals = [x * self.R % self.modulus for x in vals]
        return torch.as_tensor(ints_to_array(vals, self.n_words),
                               device=resolve(device))

    def to_ints(self, a, mont: bool = True) -> list:
        vals = array_to_ints(a.reshape(self.n_words, -1))
        if mont:
            r_inv = pow(self.R, -1, self.modulus)
            vals = [x * r_inv % self.modulus for x in vals]
        return vals


FP = LimbField(P)
FR = LimbField(R_ORDER)


@functools.lru_cache(maxsize=None)
def fp_for(mul_impl: str = "cios") -> LimbField:
    """The base field whose multiply is `mul_impl` (FP for "cios")."""
    return FP if mul_impl == "cios" else LimbField(P, mul_impl=mul_impl)

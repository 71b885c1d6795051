"""MSM parameterization: bucket sets, digit-conversion tables, per-n configs.

A copy of msm_blst_tpu/msm/params.py: importing that module runs
msm_blst_tpu/msm/__init__.py, which imports JAX. The bucket set and the
digit conversion table come from the native library (native.py) unless the
caller names the numpy twin (`use_native=False`), as in the JAX package
when its library is built. tests/test_torch_msm.py and
tests/test_torch_native.py hold every table here equal to the JAX
package's.

Host-side, init-time integer machinery (numpy + Python ints). Behavioral spec:
  * bucket set construction — reference auxiliaryfunc.h:257-288
  * digit conversion table  — reference main_p1.cpp:139-153
  * parameter table         — reference ches_config_files/*.h (SURVEY.md §2g)

The bucket-set removals are order-sensitive (they test membership against
the mutating set), so they stay a sequential loop; the omega parity that
seeds the set is computed for all candidates at once. Each table is built
once per config and cached.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..constants import R_ORDER

D_MAX_DIFF = 6
MULTI_SET = (1, 2, 3)


def _omega23_even(n: int) -> np.ndarray:
    """bool[n+1]: entry i > 0 is True iff omega2(i) + omega3(i) is even."""
    v = np.arange(n + 1, dtype=np.int64)
    v[0] = 1
    e = np.zeros(n + 1, dtype=np.int64)
    for f in (2, 3):
        hit = v % f == 0
        while hit.any():
            e += hit
            v[hit] //= f
            hit = v % f == 0
    return e % 2 == 0


@functools.lru_cache(maxsize=None)
def construct_bucket_set(q: int, ah: int,
                         use_native: bool | None = None) -> np.ndarray:
    """The CHES reduced bucket set B, |B| ~ 0.21 q, sorted ascending int32.
    `use_native`: None or True builds it natively, False with numpy."""
    if use_native is not False:
        from .. import native

        return native.construct_bucket_set(q, ah)
    even = _omega23_even(max(q // 2, ah + 1))
    B = {0, 1} | set((np.nonzero(even[2: q // 2 + 1])[0] + 2).tolist())
    for i in range(q // 4, q // 2):
        if i in B and (q - 2 * i) in B:
            B.discard(q - 2 * i)
    for i in range(q // 6, q // 4):
        if i in B and (q - 3 * i) in B:
            B.discard(q - 3 * i)
    B |= set((np.nonzero(even[1: ah + 2])[0] + 1).tolist())
    return np.array(sorted(B), dtype=np.int32)


@functools.lru_cache(maxsize=None)
def digit_conversion_table(q: int, ah: int, use_native: bool | None = None):
    """(m, b, alpha) arrays of size q+1: digit -> m*b (alpha=0) or q - m*b
    (alpha=1, i.e. negate and carry), and the bool mask of the digits
    written. Write order matters (exact-product entries must win over
    q-m*b entries), matching main_p1.cpp:139-153. `use_native`: None or
    True builds the tables natively (every written entry has m >= 1, so
    the mask is m != 0), False with numpy."""
    bucket_set = construct_bucket_set(q, ah, use_native)
    if use_native is not False:
        from .. import native

        m_t, b_t, a_t, _ = native.digit_conversion_table(q, bucket_set)
        return m_t, b_t, a_t, m_t != 0
    m_t = np.zeros(q + 1, dtype=np.int32)
    b_t = np.zeros(q + 1, dtype=np.int32)
    a_t = np.zeros(q + 1, dtype=np.int32)
    written = np.zeros(q + 1, dtype=bool)
    b64 = bucket_set.astype(np.int64)
    for alpha in (1, 0):  # q - m*b entries first so exact m*b entries overwrite
        for m in MULTI_SET:
            prod = m * b64
            ok = prod <= q
            idx = (q - prod[ok]) if alpha == 1 else prod[ok]
            m_t[idx] = m
            b_t[idx] = b64[ok]
            a_t[idx] = alpha
            written[idx] = True
    return m_t, b_t, a_t, written


def check_bucket_set_validity(q: int, ah: int) -> None:
    """Every digit value in [0, q] must decompose as +-m*b (+carry), and no
    two neighbours in the set may lie more than D_MAX_DIFF apart. Raises
    ValueError on failure (reference main_bucket_set_construction.cpp:
    74-122)."""
    _, _, _, written = digit_conversion_table(q, ah)
    missing = np.nonzero(~written)[0]
    if missing.size:
        raise ValueError(f"bucket set (q={q}, ah={ah}) misses digits "
                         f"{missing[:10]}")
    bs = construct_bucket_set(q, ah)
    gaps = np.diff(bs)
    if gaps.max(initial=1) > D_MAX_DIFF:
        raise ValueError(f"bucket set gap {gaps.max()} exceeds "
                         f"d_MAX_DIFF={D_MAX_DIFF}")


@functools.lru_cache(maxsize=None)
def packed_digit_table(q: int, ah: int) -> np.ndarray:
    """int32[q+1] packing the whole digit conversion per entry:
    bits 0..23 = bucket INDEX (value_to_index pre-composed over b), bits
    24..25 = m-1, bit 26 = alpha. One gather per window digit on device
    instead of three table gathers plus the value->index gather."""
    m_t, b_t, a_t, _ = digit_conversion_table(q, ah)
    v2i = bucket_value_to_index(q, ah)
    key = v2i[b_t]
    m1 = np.where(m_t > 0, m_t - 1, 0)
    return (key | (m1 << 24) | (a_t << 26)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def packed_digit_table_pairs(q: int, ah: int) -> np.ndarray:
    """int32[q+1, 2]: row d = (packed[d], packed[d+1]) — the carry-
    speculative device recode needs BOTH candidate entries per digit, and
    one 8-byte row gather is cheaper than two element gathers (the per-
    access cost dominates on TPU; recode measured 107 ms of the n=2^19
    CHES query with the 2-gather form)."""
    t = packed_digit_table(q, ah)
    shifted = np.concatenate([t[1:], t[:1]])  # row q never read (digit < q)
    return np.stack([t, shifted], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def packed_digit_table_value(q: int, ah: int) -> np.ndarray:
    """int32[q+1]: packed_digit_table with the bucket VALUE b in bits
    0..23 in place of its index (the noindexhash variant, reference
    multi_scalar.c:466-503): the bucket array is indexed by value (q/2 + 2
    entries) and the value->index map disappears."""
    m_t, b_t, a_t, _ = digit_conversion_table(q, ah)
    m1 = np.where(m_t > 0, m_t - 1, 0)
    return (b_t | (m1 << 24) | (a_t << 26)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def bucket_value_to_index(q: int, ah: int) -> np.ndarray:
    """Inverse map over [0, q/2]: bucket value -> index in the sorted set."""
    bs = construct_bucket_set(q, ah)
    inv = np.zeros(q // 2 + 2, dtype=np.int32)
    inv[bs] = np.arange(len(bs), dtype=np.int32)
    return inv


@dataclass(frozen=True)
class MsmConfig:
    """One row of the reference's config headers (SURVEY.md §2g)."""

    n_exp: int              # log2 number of points
    c: int                  # CHES: EXPONENT_OF_q
    h: int                  # CHES: digits per scalar
    ah: int                 # CHES: leading-term bound
    b_size: int             # CHES: |bucket set| (validated against construction)
    c_bgmw: int             # BGMW95: exponent of q'
    h_bgmw: int             # BGMW95: digits per scalar
    d_max: int = D_MAX_DIFF

    @property
    def n(self) -> int:
        return 1 << self.n_exp

    @property
    def q(self) -> int:
        return 1 << self.c

    @property
    def q_bgmw(self) -> int:
        return 1 << self.c_bgmw

    def bucket_set(self) -> np.ndarray:
        bs = construct_bucket_set(self.q, self.ah)
        assert len(bs) == self.b_size, (len(bs), self.b_size)
        return bs


# The 17 shipped parameter sets (ches_config_files/config_file_n_exp_*.h).
# Keys: n_exp (int) or "<n_exp>b" for the beta variants.
CONFIGS = {
    8: MsmConfig(8, 12, 22, 7, 857, 10, 26),
    9: MsmConfig(9, 13, 20, 231, 1725, 11, 24),
    10: MsmConfig(10, 13, 20, 231, 1725, 12, 22),
    11: MsmConfig(11, 14, 19, 7, 3417, 13, 20),
    12: MsmConfig(12, 14, 19, 7, 3417, 13, 20),
    13: MsmConfig(13, 16, 16, 29677, 18343, 15, 17),
    14: MsmConfig(14, 16, 16, 29677, 18343, 15, 17),
    15: MsmConfig(15, 16, 16, 29677, 18343, 16, 16),
    16: MsmConfig(16, 19, 14, 231, 109244, 17, 15),
    "16b": MsmConfig(16, 18, 15, 7, 54618, 17, 15),
    17: MsmConfig(17, 20, 13, 29677, 220931, 17, 15),
    "17b": MsmConfig(17, 19, 14, 231, 109244, 17, 15),
    18: MsmConfig(18, 20, 13, 29677, 220931, 19, 14),
    19: MsmConfig(19, 20, 13, 29677, 220931, 20, 13),
    20: MsmConfig(20, 22, 12, 7419, 874437, 20, 13),
    "20b": MsmConfig(20, 20, 13, 29677, 220931, 20, 13),
    21: MsmConfig(21, 22, 12, 7419, 874437, 22, 12),
}


def make_config(n_exp: int, c: int, h: int, ah: int | None = None,
                c_bgmw: int | None = None, h_bgmw: int | None = None) -> MsmConfig:
    """Build a custom (e.g. test-size) config; b_size derived from construction.

    `ah` defaults to the true leading-digit bound floor(r / q^(h-1)); with that
    bound every top digit (plus a possible +1 carry) lies in [0, ah+1], where
    the bucket-set construction guarantees carry-free (alpha=0) decompositions.
    """
    q = 1 << c
    assert c * h >= 255, "digit decomposition must cover 255-bit scalars"
    if ah is None:
        ah = R_ORDER >> (c * (h - 1))
    assert ah >= R_ORDER >> (c * (h - 1)), "leading bound below max top digit"
    bs = construct_bucket_set(q, ah)
    c_bgmw = c_bgmw if c_bgmw is not None else c
    h_bgmw = h_bgmw if h_bgmw is not None else -(-256 // c_bgmw)
    return MsmConfig(n_exp, c, h, ah, len(bs), c_bgmw, h_bgmw)

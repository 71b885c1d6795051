"""Scalar recoding for the CHES query: host scalar containers and the
on-device carry-speculative MB-radix-q recode.

Port of msm_blst_tpu/msm/recode.py:25-95, 229-249, 276-309. Scalars cross
the host boundary as uint32[8, n] little-endian words (numpy, as in the JAX
package) and live on the device as int32[8, n] with the same bits
(`to_device`). The device functions widen words to int64 and mask before
any shift or compare, since torch compares int32 as signed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import R_ORDER

WORD_MASK = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# host scalar containers (numpy copies of the JAX package's; tested equal)
# ---------------------------------------------------------------------------


def scalars_from_ints(xs) -> np.ndarray:
    """Python ints -> uint32[8, n] little-endian."""
    out = np.zeros((8, len(xs)), dtype=np.uint32)
    for j, x in enumerate(xs):
        assert 0 <= x < (1 << 256)
        for i in range(8):
            out[i, j] = (x >> (32 * i)) & WORD_MASK
    return out


def scalars_to_ints(a: np.ndarray) -> list:
    return [
        sum(int(a[i, j]) << (32 * i) for i in range(8)) for j in range(a.shape[1])
    ]


def random_scalars(n: int, seed: int) -> np.ndarray:
    """Deterministic scalars < r from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        x = int.from_bytes(rng.bytes(32), "little") >> 1  # 255-bit
        if x < R_ORDER:
            out.append(x)
    return scalars_from_ints(out)


def to_device(scalars_u32: np.ndarray, device=None) -> torch.Tensor:
    """Host uint32[8, n] scalars -> int32[8, n] tensor on `device`."""
    a = np.ascontiguousarray(scalars_u32, dtype=np.uint32)
    return torch.as_tensor(a.view(np.int32), device=device)


# ---------------------------------------------------------------------------
# device recoding
# ---------------------------------------------------------------------------

_R_WORDS = [(R_ORDER >> (32 * i)) & WORD_MASK for i in range(8)]


def _words64(scalars: torch.Tensor) -> torch.Tensor:
    return scalars.to(torch.int64) & WORD_MASK


def reduce_mod_r_device(scalars: torch.Tensor) -> torch.Tensor:
    """Scalars in [r, 2^256) lose one r (2^255 < 2r for the inputs the
    recoding sees); branch-free conditional subtract. int32[8, n] in/out."""
    s = _words64(scalars)
    ge = torch.zeros(s.shape[1:], dtype=torch.bool, device=s.device)
    eq = torch.ones(s.shape[1:], dtype=torch.bool, device=s.device)
    for i in range(7, -1, -1):
        ge = ge | (eq & (s[i] > _R_WORDS[i]))
        eq = eq & (s[i] == _R_WORDS[i])
    ge = ge | eq
    out = []
    borrow = torch.zeros_like(s[0])
    for i in range(8):
        d = (s[i] - _R_WORDS[i] - borrow) & WORD_MASK
        borrow = ((s[i] < _R_WORDS[i])
                  | ((s[i] == _R_WORDS[i]) & (borrow != 0))).to(torch.int64)
        out.append(d)
    sub = torch.stack(out)
    res = torch.where(ge, sub, s)
    return (res - ((res >> 31) << 32)).to(torch.int32)


def qary_digits_device(scalars: torch.Tensor, c: int, h: int) -> torch.Tensor:
    """int32[8, n] scalars -> int32[h, n] standard q-ary digits (bits
    [j*c, (j+1)*c)). Windows entirely past the 256-bit scalar are zero."""
    s = _words64(scalars)
    mask = (1 << c) - 1
    rows = []
    for j in range(h):
        bit = j * c
        w, off = bit // 32, bit % 32
        if w >= s.shape[0]:
            rows.append(torch.zeros(s.shape[1:], dtype=torch.int32,
                                    device=s.device))
            continue
        d = s[w] >> off
        if off + c > 32 and w + 1 < s.shape[0]:
            d = d | (s[w + 1] << (32 - off))
        rows.append((d & mask).to(torch.int32))
    return torch.stack(rows)


def ches_recode_device_packed(scalars: torch.Tensor, c: int, h: int,
                              packed_table: torch.Tensor):
    """Device MB-radix-q recoding off the pairs table
    (params.packed_digit_table_pairs, int32[q+1, 2]): both candidate entries
    (digit and digit+1) in one row gather, then the +1 carry chain as h
    integer selects. Digits lie in [0, q-1], so every row index is in range.

    Returns (key int32[h, n], m1 int32[h, n] in {0,1,2}, sign bool[h, n])."""
    digits = qary_digits_device(reduce_mod_r_device(scalars), c, h)
    n = digits.shape[1]
    spec = packed_table[digits.to(torch.int64)]  # [h, n, 2]
    p0, p1 = spec[..., 0], spec[..., 1]
    a0 = (p0 >> 26) & 1
    a1 = (p1 >> 26) & 1
    carry = torch.zeros(n, dtype=torch.int32, device=digits.device)
    carries = []
    for j in range(h):
        carries.append(carry)
        if j < h - 1:
            carry = torch.where(carry != 0, a1[j], a0[j])
    p = torch.where(torch.stack(carries) != 0, p1, p0)
    return p & 0xFFFFFF, (p >> 24) & 3, ((p >> 26) & 1) == 1

"""Scalar recoding: host scalar containers, the host CHES and BGMW95
recodes, the on-device carry-speculative MB-radix-q recode, and the device
BGMW95 / stock signed q/2 recode with the r - a fold.

Port of msm_blst_tpu/msm/recode.py:25-226, 229-273, 276-356. The host
recodes run the native library (native.py, C++) unless the caller names
the numpy twin (`use_native=False`), as the JAX package's do when its
library is built; the twin is what the tests hold the native pass against.
Scalars cross the host boundary as uint32[8, n] little-endian words (numpy,
as in the JAX package) and live on the device as int32[8, n] with the same
bits (`to_device`). The device functions widen words to int64 and mask
before any shift or compare, since torch compares int32 as signed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import R_ORDER
from ..device import resolve

WORD_MASK = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# host scalar containers (numpy copies of the JAX package's; tested equal)
# ---------------------------------------------------------------------------


def scalars_from_ints(xs) -> np.ndarray:
    """Python ints in [0, 2^256) -> uint32[8, n] little-endian: one join of
    their 32-byte little-endian forms, read as words (an int outside the
    range raises OverflowError)."""
    raw = b"".join(int(x).to_bytes(32, "little") for x in xs)
    words = np.frombuffer(raw, dtype="<u4").astype(np.uint32)
    return np.ascontiguousarray(words.reshape(-1, 8).T)


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


_R_WORDS_NP = np.array([(R_ORDER >> (32 * i)) & WORD_MASK for i in range(8)],
                       dtype=np.uint64)


def reduce_mod_r_host(scalars_u32: np.ndarray) -> np.ndarray:
    """Scalars in [r, 2^256) lose one r (2^255 < 2r for the inputs the
    recoding sees). Vectorised over the words: a lexicographic compare from
    the top word, then one borrow chain."""
    s = np.asarray(scalars_u32, dtype=np.uint32).astype(np.int64)
    r = _R_WORDS_NP.astype(np.int64)
    ge = np.zeros(s.shape[1:], dtype=bool)
    eq = np.ones(s.shape[1:], dtype=bool)
    for i in range(7, -1, -1):
        ge |= eq & (s[i] > r[i])
        eq &= s[i] == r[i]
    ge |= eq
    if not ge.any():
        return scalars_u32
    out = np.empty_like(s)
    borrow = np.zeros(s.shape[1:], dtype=np.int64)
    for i in range(8):
        d = s[i] - r[i] - borrow
        borrow = (d < 0).astype(np.int64)
        out[i] = d & WORD_MASK
    return np.where(ge, out, s).astype(np.uint32)


def qary_digits_host(scalars_u32: np.ndarray, c: int, h: int) -> np.ndarray:
    """Standard q-ary digits: int32[n, h], digit j = bits [j*c, (j+1)*c)
    (reference auxiliaryfunc.h:83-90)."""
    n = scalars_u32.shape[1]
    words = scalars_u32.astype(np.uint64)  # (8, n)
    digits = np.zeros((n, h), dtype=np.int64)
    mask = np.uint64((1 << c) - 1)
    for j in range(h):
        bit = j * c
        w, off = bit // 32, bit % 32
        if w >= words.shape[0]:  # windows past bit 256 are zero
            continue
        d = words[w] >> np.uint64(off)
        if off + c > 32 and w + 1 < words.shape[0]:
            d |= words[w + 1] << np.uint64(32 - off)
        if off + c > 64 and w + 2 < words.shape[0]:
            d |= words[w + 2] << np.uint64(64 - off)
        digits[:, j] = (d & mask).astype(np.int64)
    return digits.astype(np.int32)


def ches_recode_host(scalars_u32: np.ndarray, c: int, h: int, ah: int,
                     use_native: bool | None = None):
    """MB-radix-q recoding on the host (reference auxiliaryfunc.h:92-118):
    per digit (m in {1,2,3}, bucket value b, sign), carrying +1 on alpha=1
    digits. Returns (b int32[n, h], m int32[n, h], sign bool[n, h]).

    `use_native`: None or True runs the native pass (native.ches_recode),
    False the numpy twin; both raise ValueError when the leading digit
    carries."""
    from .params import digit_conversion_table

    scalars_u32 = reduce_mod_r_host(scalars_u32)
    m_t, b_t, a_t, _ = digit_conversion_table(1 << c, ah, use_native)
    if use_native is not False:
        from .. import native

        b_g, m_g, s_g = native.ches_recode(scalars_u32, c, h, m_t, b_t, a_t)
        return b_g.T.copy(), m_g.T.copy(), s_g.T.copy()
    digits = qary_digits_host(scalars_u32, c, h)
    n = digits.shape[0]
    b_out = np.zeros((n, h), dtype=np.int32)
    m_out = np.zeros((n, h), dtype=np.int32)
    s_out = np.zeros((n, h), dtype=bool)
    carry = np.zeros(n, dtype=np.int32)
    for j in range(h):
        d = digits[:, j] + carry
        b_out[:, j] = b_t[d]
        m_out[:, j] = m_t[d]
        carry = a_t[d]
        s_out[:, j] = carry == 1
    if s_out[:, h - 1].any():
        raise ValueError("leading CHES digit required a carry; the config's "
                         "a_h must prevent this")
    return b_out, m_out, s_out


def _r_minus_host(s: np.ndarray) -> np.ndarray:
    """r - a of uint32[8, n] scalars a <= r, one borrow chain."""
    s = s.astype(np.int64)
    r = _R_WORDS_NP.astype(np.int64)
    out = np.empty_like(s)
    borrow = np.zeros(s.shape[1:], dtype=np.int64)
    for i in range(8):
        d = r[i] - s[i] - borrow
        borrow = (d < 0).astype(np.int64)
        out[i] = d & WORD_MASK
    return out.astype(np.uint32)


def _signed_q2_host(scalars_u32: np.ndarray, c: int, h: int):
    """Signed q/2 digits int64[n, h]: digits above q/2 become d - q and
    carry one into the next window (the top window keeps its carry)."""
    q = 1 << c
    digits = qary_digits_host(scalars_u32, c, h).astype(np.int64)
    half = q >> 1
    for j in range(h - 1):
        over = digits[:, j] > half
        digits[:, j] -= np.where(over, q, 0)
        digits[:, j + 1] += over
    if (digits[:, h - 1] > half).any():
        raise ValueError("BGMW95 leading digit exceeds q/2")
    return digits


def bgmw_recode_host(scalars_u32: np.ndarray, c: int, h: int,
                     use_native: bool | None = None):
    """BGMW95 signed q/2 recoding with the r - a trick for tight configs
    (reference auxiliaryfunc.h:130-145 and main_p1.cpp:294-398): where
    c*h <= 255 and a scalar's top 64 bits exceed 2^62, a becomes r - a and
    its digit signs flip. Returns (|digit| int32[n, h], sign bool[n, h]).

    `use_native`: None or True runs the native pass (native.bgmw_recode),
    False the numpy twin."""
    scalars_u32 = reduce_mod_r_host(scalars_u32)
    tight = c * h <= 255  # needs the group-order negation trick
    if use_native is not False:
        from .. import native

        a_g, s_g = native.bgmw_recode(scalars_u32, c, h, tight)
        return a_g.T.copy(), s_g.T.copy()
    scal = scalars_u32
    flip = np.zeros(scalars_u32.shape[1], dtype=bool)
    if tight:
        # condition: top 64 bits > 2^62  (main_p1.cpp:311-318)
        top = scalars_u32[6].astype(np.uint64) | (
            scalars_u32[7].astype(np.uint64) << np.uint64(32))
        flip = top > np.uint64(1 << 62)
        scal = np.where(flip, _r_minus_host(scalars_u32), scalars_u32)
    digits = _signed_q2_host(scal, c, h)
    sign = digits < 0
    absd = np.abs(digits).astype(np.int32)
    sign ^= flip[:, None]
    sign &= absd != 0
    return absd, sign


def booth_recode_host(scalars_u32: np.ndarray, c: int):
    """Signed-window recoding for the stock (no-precompute) Pippenger path:
    h = ceil(256/c) windows of signed digits in [-q/2, q/2] with
    sum digit_j * q^j == scalar (blst's booth encoding, reference
    ec_mult.h:46-55, may choose other digits)."""
    return bgmw_recode_host_nofold(scalars_u32, c, -(-256 // c))


def bgmw_recode_host_nofold(scalars_u32: np.ndarray, c: int, h: int):
    """The signed q/2 recoding without the r - a fold. Returns (|digit|
    int32[n, h], sign bool[n, h])."""
    digits = _signed_q2_host(scalars_u32, c, h)
    sign = digits < 0
    absd = np.abs(digits).astype(np.int32)
    sign &= absd != 0
    return absd, sign


def to_device(scalars_u32: np.ndarray, device=None) -> torch.Tensor:
    """Host uint32[8, n] scalars -> int32[8, n] tensor on `device`
    (default: the card)."""
    a = np.ascontiguousarray(scalars_u32, dtype=np.uint32)
    return torch.as_tensor(a.view(np.int32), device=resolve(device))


# ---------------------------------------------------------------------------
# device recoding
# ---------------------------------------------------------------------------

_R_WORDS = [(R_ORDER >> (32 * i)) & WORD_MASK for i in range(8)]


def _words64(scalars: torch.Tensor) -> torch.Tensor:
    return scalars.to(torch.int64) & WORD_MASK


def _words32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


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
    return _words32(torch.where(ge, sub, s))


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


def ches_recode_device(scalars: torch.Tensor, c: int, h: int, tables):
    """Device MB-radix-q recoding off the unpacked digit tables `tables` =
    (m_t, b_t, a_t), int32[q+1] tensors (params.digit_conversion_table's
    first three): h sequential lookups, each window's digit plus the carry
    the window below left (alpha), as the JAX package's
    ches_recode_device. The port's queries read the packed table
    (ches_recode_device_packed), which every plan carries.

    Returns (b int32[h, n], m int32[h, n], sign bool[h, n])."""
    m_t, b_t, a_t = tables
    digits = qary_digits_device(reduce_mod_r_device(scalars), c, h)
    carry = torch.zeros(digits.shape[1], dtype=torch.int32,
                        device=digits.device)
    bs, ms, ss = [], [], []
    for j in range(h):
        d = (digits[j] + carry).to(torch.int64)
        bs.append(b_t[d])
        ms.append(m_t[d])
        carry = a_t[d]
        ss.append(carry == 1)
    return torch.stack(bs), torch.stack(ms), torch.stack(ss)


def ches_recode_device_packed(scalars: torch.Tensor, c: int, h: int,
                              packed_table: torch.Tensor):
    """Device MB-radix-q recoding off a packed digit table: the pairs
    layout (params.packed_digit_table_pairs, int32[q+1, 2]), both candidate
    entries (digit and digit+1) in one row gather; or a 1-D table of q+1
    entries (params.packed_digit_table_value, the noindexhash keys), both
    candidates in one gather of [2, h, n] indices. Then the +1 carry chain
    as h integer selects. Digits lie in [0, q-1] and digit+1 <= q, so
    every index is in range.

    Returns (key int32[h, n], m1 int32[h, n] in {0,1,2}, sign bool[h, n])."""
    digits = qary_digits_device(reduce_mod_r_device(scalars), c, h)
    n = digits.shape[1]
    idx = digits.to(torch.int64)
    if packed_table.ndim == 2:
        spec = packed_table[idx]  # [h, n, 2]
        p0, p1 = spec[..., 0], spec[..., 1]
    else:
        p0, p1 = packed_table[torch.stack([idx, idx + 1])]
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


def fold_r_minus_a_device(scalars: torch.Tensor):
    """The group-order negation trick (reference main_p1.cpp:311-356): where
    the scalar's top 64 bits exceed 2^62, a becomes r - a and the flip mask
    inverts every digit sign. int32[8, n] in; (folded int32[8, n], flip
    bool[n]) out. The top-word compare with 2^30 is unsigned."""
    s = _words64(scalars)
    hi = 1 << 30
    flip = (s[7] > hi) | ((s[7] == hi) & (s[6] > 0))
    out = []
    borrow = torch.zeros_like(s[0])
    for i in range(8):
        d = (_R_WORDS[i] - s[i] - borrow) & WORD_MASK
        borrow = ((s[i] > _R_WORDS[i])
                  | ((s[i] == _R_WORDS[i]) & (borrow != 0))).to(torch.int64)
        out.append(d)
    return _words32(torch.where(flip, torch.stack(out), s)), flip


def signed_digits_device(scalars: torch.Tensor, c: int, h: int):
    """Signed q/2 recoding without the r - a fold: digits above q/2 become
    d - q and carry one into the next window (the top window keeps its
    carry). Returns (|digit| int32[h, n], sign bool[h, n])."""
    q = 1 << c
    half = q >> 1
    digits = qary_digits_device(scalars, c, h).to(torch.int64)
    carry = torch.zeros_like(digits[0])
    outs = []
    for j in range(h):
        d = digits[j] + carry
        if j < h - 1:
            over = d > half
            carry = over.to(torch.int64)
            d = torch.where(over, d - q, d)
        outs.append(d)
    d = torch.stack(outs)
    return d.abs().to(torch.int32), d < 0


def bgmw_digits_device(scalars: torch.Tensor, c: int, h: int):
    """The BGMW95 digits of int32[8, n] scalars: reduced mod r first (the
    recodes' domain is [0, 2^255)), then for tight configs (c*h <= 255,
    where the top digit bound exceeds q/2) the group-order fold a -> r - a,
    whose flip inverts the digit signs, as the reference does on the host;
    then the signed q/2 digits. Returns (|digit| int32[h, n], sign
    bool[h, n])."""
    scalars = reduce_mod_r_device(scalars)
    flip = None
    if c * h <= 255:
        scalars, flip = fold_r_minus_a_device(scalars)
    absd, sign = signed_digits_device(scalars, c, h)
    if flip is not None:
        sign = sign ^ flip[None, :]
    return absd, sign

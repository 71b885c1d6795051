"""Byte/word-level conversions for scalars and field elements.

Copy of msm_blst_tpu/utils/exports.py for the port. Capability twin of
blst's C-ABI conversion layer
(blst's src/exports.c: blst_fr/fp/scalar from/to uint32, uint64,
big-endian and little-endian bytes, hex) plus the scalar validity checks
(blst_scalar_fr_check, blst_sk_check).

Host-side helpers (plain ints <-> bytes/words) and device-batch ingest
(ints <-> the uint32[8, n] scalar layout / the port's int32[12, n] Fp
words).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from ..constants import P, R_ORDER

# ---------------------------------------------------------------------------
# int <-> bytes / words (blst_scalar_from_* twins)
# ---------------------------------------------------------------------------


def scalar_from_bendian(b: bytes) -> int:
    """32 big-endian bytes -> int (blst_scalar_from_bendian)."""
    if len(b) != 32:
        raise ValueError("scalar must be 32 bytes")
    return int.from_bytes(b, "big")


def scalar_to_bendian(x: int) -> bytes:
    return (x % (1 << 256)).to_bytes(32, "big")


def scalar_from_lendian(b: bytes) -> int:
    if len(b) != 32:
        raise ValueError("scalar must be 32 bytes")
    return int.from_bytes(b, "little")


def scalar_to_lendian(x: int) -> bytes:
    return (x % (1 << 256)).to_bytes(32, "little")


def scalar_from_uint32(words: Sequence[int]) -> int:
    if len(words) != 8:
        raise ValueError("need 8 uint32 words")
    return sum((w & 0xFFFFFFFF) << (32 * i) for i, w in enumerate(words))


def scalar_to_uint32(x: int) -> List[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def scalar_from_uint64(words: Sequence[int]) -> int:
    if len(words) != 4:
        raise ValueError("need 4 uint64 words")
    return sum((w & 0xFFFFFFFFFFFFFFFF) << (64 * i) for i, w in enumerate(words))


def scalar_to_uint64(x: int) -> List[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(4)]


def scalar_from_hex(s: str) -> int:
    return int(s, 16)


def scalar_fr_check(x: int) -> bool:
    """blst_scalar_fr_check: canonical scalar < r."""
    return 0 <= x < R_ORDER


def sk_check(x: int) -> bool:
    """blst_sk_check: nonzero canonical scalar."""
    return 0 < x < R_ORDER


# ---------------------------------------------------------------------------
# fr / fp reductions (blst_fr_from_scalar / blst_scalar_from_fr semantics)
# ---------------------------------------------------------------------------


def fr_from_scalar(x: int) -> int:
    return x % R_ORDER

def fp_from_bendian(b: bytes) -> int:
    """48 big-endian bytes -> Fp element; rejects non-canonical
    (blst_fp_from_bendian)."""
    if len(b) != 48:
        raise ValueError("fp must be 48 bytes")
    v = int.from_bytes(b, "big")
    if v >= P:
        raise ValueError("fp not canonical")
    return v


def fp_to_bendian(x: int) -> bytes:
    return (x % P).to_bytes(48, "big")


def fp_from_lendian(b: bytes) -> int:
    if len(b) != 48:
        raise ValueError("fp must be 48 bytes")
    v = int.from_bytes(b, "little")
    if v >= P:
        raise ValueError("fp not canonical")
    return v


def fp_to_lendian(x: int) -> bytes:
    return (x % P).to_bytes(48, "little")


# ---------------------------------------------------------------------------
# batch ingest: bytes streams <-> device layouts
# ---------------------------------------------------------------------------


def scalars_from_bendian_batch(bs: Iterable[bytes]) -> np.ndarray:
    """Iterable of 32-byte big-endian scalars -> uint32[8, n] device layout."""
    from ..msm.recode import scalars_from_ints

    return scalars_from_ints([scalar_from_bendian(b) for b in bs])


def scalars_to_bendian_batch(a: np.ndarray) -> List[bytes]:
    from ..msm.recode import scalars_to_ints

    return [scalar_to_bendian(x) for x in scalars_to_ints(a)]


def fp_batch_to_device(vals: Iterable[int], mont: bool = True, device=None):
    """Canonical Fp ints -> the port's batch int32[12, n] (Montgomery form
    by default) on `device` (default: the card)."""
    from ..fields.limb import FP

    return FP.from_ints(list(vals), mont=mont, device=device)


def fp_batch_from_device(a, mont: bool = True) -> List[int]:
    """An int32[12, n] batch (on any device) -> canonical Fp ints."""
    from ..fields.limb import FP

    return FP.to_ints(a, mont=mont)

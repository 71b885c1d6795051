"""ZCash-format point serialization for BLS12-381 G1/G2.

Copy of msm_blst_tpu/curves/serialize.py for the port. Behavioral spec:
blst's src/e1.c:139-359 (G1) and src/e2.c:176-419 (G2) — the standard ZCash
encoding:

  * uncompressed: big-endian x || y (96 B G1, 192 B G2; G2 component order is
    imaginary-first: x.c1 || x.c0 || y.c1 || y.c0)
  * compressed: big-endian x with flag bits in the top byte:
      0x80 compressed, 0x40 infinity, 0x20 y is lexicographically largest
  * infinity: flags + zeros.

Host-side (bytes in/out); batch device export goes through affine_to_ints.
"""

from __future__ import annotations

from ..constants import P
from ..refimpl import G1_REF, G2_REF

_HALF = (P - 1) // 2


def _fp_to_bytes(v: int) -> bytes:
    return v.to_bytes(48, "big")


def _fp_from_bytes(b: bytes) -> int:
    v = int.from_bytes(b, "big")
    if v >= P:
        raise ValueError("field element not canonical")
    return v


def _y_is_large_g1(y: int) -> bool:
    return y > _HALF


def _y_is_large_g2(y) -> bool:
    c0, c1 = y
    return c1 > _HALF or (c1 == 0 and c0 > _HALF)


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------


def g1_compress(pt) -> bytes:
    """(x, y) ints, (0,0) = infinity -> 48 bytes."""
    x, y = pt
    if x == 0 and y == 0:
        return bytes([0xC0]) + bytes(47)
    out = bytearray(_fp_to_bytes(x))
    out[0] |= 0x80
    if _y_is_large_g1(y):
        out[0] |= 0x20
    return bytes(out)


def g1_serialize(pt) -> bytes:
    x, y = pt
    if x == 0 and y == 0:
        return bytes([0x40]) + bytes(95)
    return _fp_to_bytes(x) + _fp_to_bytes(y)


def g1_uncompress(b: bytes):
    if len(b) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("compressed bit not set")
    if flags & 0x40:
        if any(b[1:]) or flags & 0x3F:
            raise ValueError("malformed infinity")
        return (0, 0)
    x = _fp_from_bytes(bytes([flags & 0x1F]) + b[1:])
    yy = (pow(x, 3, P) + 4) % P
    y = _sqrt_fp(yy)
    if y is None:
        raise ValueError("x not on curve")
    if _y_is_large_g1(y) != bool(flags & 0x20):
        y = P - y
    return (x, y)


def g1_deserialize(b: bytes):
    if len(b) == 48:
        return g1_uncompress(b)
    if len(b) != 96:
        raise ValueError("G1 point must be 48 or 96 bytes")
    if b[0] & 0x80:
        return g1_uncompress(b[:48])
    if b[0] & 0x40:
        if any(b[1:]) or b[0] & 0x3F:
            raise ValueError("malformed infinity")
        return (0, 0)
    x = _fp_from_bytes(b[:48])
    y = _fp_from_bytes(b[48:])
    if not G1_REF.is_on_curve((type(G1_REF.b)(x), type(G1_REF.b)(y))):
        raise ValueError("point not on curve")
    return (x, y)


def _sqrt_fp(a: int):
    """sqrt mod P (P = 3 mod 4): a^((P+1)/4); None if non-residue."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a else None


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------


def g2_compress(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    if x0 == x1 == y0 == y1 == 0:
        return bytes([0xC0]) + bytes(95)
    out = bytearray(_fp_to_bytes(x1) + _fp_to_bytes(x0))
    out[0] |= 0x80
    if _y_is_large_g2((y0, y1)):
        out[0] |= 0x20
    return bytes(out)


def g2_serialize(pt) -> bytes:
    (x0, x1), (y0, y1) = pt
    if x0 == x1 == y0 == y1 == 0:
        return bytes([0x40]) + bytes(191)
    return _fp_to_bytes(x1) + _fp_to_bytes(x0) + _fp_to_bytes(y1) + _fp_to_bytes(y0)


def _sqrt_fp2(a):
    """sqrt in Fp2 via the refimpl field (used only at deserialization)."""
    from ..refimpl.field import Fp2

    c0, c1 = a
    # exhaustive algorithm: candidate = a^((p^2+7)/16)-free approach is not
    # needed; use the simple p^2 = 9 mod 16 path via Tonelli-style search:
    # try s = a^((p^2+7)/16) * u^j for the four fourth-roots u.
    # For BLS12-381, a simpler route: solve with the norm trick.
    # norm = c0^2 + c1^2; lam = sqrt(norm); then y0^2 = (c0 + lam)/2.
    norm = (c0 * c0 + c1 * c1) % P
    lam = _sqrt_fp(norm)
    if lam is None:
        return None
    for l in (lam, P - lam):
        t = (c0 + l) * pow(2, P - 2, P) % P
        y0 = _sqrt_fp(t)
        if y0 is None:
            continue
        if y0 == 0:
            y1 = _sqrt_fp((P - c0) * pow(2, P - 2, P) % P if c1 == 0 else 0)
            if c1 == 0:
                # a = (c0, 0) with c0 a non-residue: sqrt = (0, sqrt(-c0))
                y1 = _sqrt_fp(P - c0)
                if y1 is not None:
                    return (0, y1)
                continue
            continue
        y1 = c1 * pow(2 * y0, P - 2, P) % P
        cand = Fp2(y0, y1)
        if cand.sqr() == Fp2(c0, c1):
            return (y0, y1)
    return None


def g2_uncompress(b: bytes):
    if len(b) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = b[0]
    if not flags & 0x80:
        raise ValueError("compressed bit not set")
    if flags & 0x40:
        if any(b[1:]) or flags & 0x3F:
            raise ValueError("malformed infinity")
        return ((0, 0), (0, 0))
    x1 = _fp_from_bytes(bytes([flags & 0x1F]) + b[1:48])
    x0 = _fp_from_bytes(b[48:])
    from ..refimpl.field import Fp2

    x = Fp2(x0, x1)
    yy = x.sqr() * x + G2_REF.b
    y = _sqrt_fp2((yy.c0.v, yy.c1.v))
    if y is None:
        raise ValueError("x not on curve")
    if _y_is_large_g2(y) != bool(flags & 0x20):
        y = ((P - y[0]) % P, (P - y[1]) % P)
    return ((x0, x1), y)


def g2_deserialize(b: bytes):
    if len(b) == 96:
        return g2_uncompress(b)
    if len(b) != 192:
        raise ValueError("G2 point must be 96 or 192 bytes")
    if b[0] & 0x80:
        return g2_uncompress(b[:96])
    if b[0] & 0x40:
        if any(b[1:]) or b[0] & 0x3F:
            raise ValueError("malformed infinity")
        return ((0, 0), (0, 0))
    x1 = _fp_from_bytes(b[:48])
    x0 = _fp_from_bytes(b[48:96])
    y1 = _fp_from_bytes(b[96:144])
    y0 = _fp_from_bytes(b[144:])
    from ..refimpl.field import Fp2

    if not G2_REF.is_on_curve((Fp2(x0, x1), Fp2(y0, y1))):
        raise ValueError("point not on curve")
    return ((x0, x1), (y0, y1))

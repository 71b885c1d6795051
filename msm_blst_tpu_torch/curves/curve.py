"""The G1 and G2 curve instances with host-side constant handling (port of
msm_blst_tpu/curves/curve.py), over the field of a chosen multiply.

`G1` and `G2` run their field products on K1 (CIOS); `for_mul_impl(impl)`
gives the pair over the field whose products run on `impl`'s kernel ("sos":
K6). The point kernels K2-K5 are chosen by the curve's name and keep their
own CIOS products either way: the words are the same.
"""

from __future__ import annotations

import functools
from typing import Sequence

from ..constants import B_G1, B_G2
from ..device import resolve
from ..fields.fp2 import FP2, fp2_for
from ..fields.limb import FP, fp_for
from .ops import AffinePoint, CurveOps


class G1Curve(CurveOps):
    def __init__(self, F=FP):
        super().__init__(F, "G1")
        self.b_int = B_G1

    def affine_from_ints(self, pts: Sequence, device=None) -> AffinePoint:
        """[(x, y) ints] -> Montgomery-domain AffinePoint batch on `device`
        (default: the card). Infinity is (0, 0); 0's Montgomery form is 0."""
        device = resolve(device)
        return AffinePoint(self.F.from_ints([p[0] for p in pts], device=device),
                           self.F.from_ints([p[1] for p in pts], device=device))

    def affine_to_ints(self, p: AffinePoint):
        return list(zip(self.F.to_ints(p.X), self.F.to_ints(p.Y)))


class G2Curve(CurveOps):
    def __init__(self, F=FP2):
        super().__init__(F, "G2")
        self.b_int = B_G2

    def affine_from_ints(self, pts: Sequence, device=None) -> AffinePoint:
        """[((x0, x1), (y0, y1)) ints] -> Montgomery-domain AffinePoint batch
        of int32[2, 12, n] coordinates on `device` (default: the card)."""
        device = resolve(device)
        return AffinePoint(
            self.F.from_int_pairs([p[0] for p in pts], device=device),
            self.F.from_int_pairs([p[1] for p in pts], device=device))

    def affine_to_ints(self, p: AffinePoint):
        return list(zip(self.F.to_int_pairs(p.X), self.F.to_int_pairs(p.Y)))


G1 = G1Curve()
G2 = G2Curve()


@functools.lru_cache(maxsize=None)
def for_mul_impl(mul_impl: str = "cios") -> dict:
    """{"G1": ..., "G2": ...} over the fields whose products run on
    `mul_impl` ("cios": the module-level G1 and G2)."""
    if mul_impl == "cios":
        return {"G1": G1, "G2": G2}
    return {"G1": G1Curve(fp_for(mul_impl)), "G2": G2Curve(fp2_for(mul_impl))}

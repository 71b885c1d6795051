"""The G1 and G2 curve instances with host-side constant handling (port of
msm_blst_tpu/curves/curve.py)."""

from __future__ import annotations

from typing import Sequence

from ..device import resolve
from ..fields.fp2 import FP2
from ..fields.limb import FP
from .ops import AffinePoint, CurveOps


class G1Curve(CurveOps):
    def __init__(self):
        super().__init__(FP, "G1")

    def affine_from_ints(self, pts: Sequence, device=None) -> AffinePoint:
        """[(x, y) ints] -> Montgomery-domain AffinePoint batch on `device`
        (default: the card). Infinity is (0, 0); 0's Montgomery form is 0."""
        device = resolve(device)
        return AffinePoint(FP.from_ints([p[0] for p in pts], device=device),
                           FP.from_ints([p[1] for p in pts], device=device))

    def affine_to_ints(self, p: AffinePoint):
        return list(zip(FP.to_ints(p.X), FP.to_ints(p.Y)))


class G2Curve(CurveOps):
    def __init__(self):
        super().__init__(FP2, "G2")

    def affine_from_ints(self, pts: Sequence, device=None) -> AffinePoint:
        """[((x0, x1), (y0, y1)) ints] -> Montgomery-domain AffinePoint batch
        of int32[2, 12, n] coordinates on `device` (default: the card)."""
        device = resolve(device)
        return AffinePoint(FP2.from_int_pairs([p[0] for p in pts], device=device),
                           FP2.from_int_pairs([p[1] for p in pts], device=device))

    def affine_to_ints(self, p: AffinePoint):
        return list(zip(FP2.to_int_pairs(p.X), FP2.to_int_pairs(p.Y)))


G1 = G1Curve()
G2 = G2Curve()

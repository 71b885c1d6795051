"""Batched G1 and G2 point arithmetic (xyzz and Jacobian coordinates)."""

from .curve import G1, G2, for_mul_impl  # noqa: F401
from .ops import (AffinePoint, CurveOps, JacPoint, PackedRows32,  # noqa: F401
                  XyzzPoint)

"""Batched G1 and G2 point arithmetic (xyzz and Jacobian coordinates), and
the single-point multiplications, the windowed MSM and the bulk add."""

from .curve import G1, G2, for_mul_impl  # noqa: F401
from .ops import (AffinePoint, CurveOps, JacPoint, PackedRows32,  # noqa: F401
                  XyzzPoint)
from .mult import (in_group_device, ladder_mult, msm_wbits,  # noqa: F401
                   point_mult, point_mult_ints, points_add)

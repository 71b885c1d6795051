"""EC folds and scans over xyzz batches (port of msm_blst_tpu/msm/scan.py:31-70).

The folds and suffix scans replace the reference's serial bucket
integration loops (multi_scalar.c:281-344). The segmented bucket reduction
of the JAX module is not on the port's path (the prefix pipeline replaced
it) and is not ported.
"""

from __future__ import annotations

import torch

from ..curves.ops import XyzzPoint
from ..utils import scans
from ..utils.scans import DEFAULT_CHUNK
from . import cuda_scan


def fold_xyzz(curve, pts: XyzzPoint, chunk: int = DEFAULT_CHUNK) -> XyzzPoint:
    """Sum all lanes -> batch of 1 (zero padding = infinity = identity)."""
    return scans.fold(curve.xyzz_dadd, pts, chunk)


def suffix_scan_xyzz(curve, pts: XyzzPoint,
                     chunk: int = DEFAULT_CHUNK) -> XyzzPoint:
    """Inclusive suffix sums S_i = sum_{j>=i} pts[j], full width. A 1-D
    batch goes through the level kernel (cuda_scan.prefix_scan_xyzz) on the
    flipped stream; torch.flip stands in for JAX's reversed slice."""
    if pts.X.ndim == 2:
        rev = XyzzPoint(*(torch.flip(c, dims=(-1,)) for c in pts))
        out = cuda_scan.prefix_scan_xyzz(curve, rev)
        return XyzzPoint(*(torch.flip(c, dims=(-1,)) for c in out))
    return scans.suffix_scan(curve.xyzz_dadd, pts, chunk)


def scan_fold_axis(curve, pts: XyzzPoint, axis: int) -> XyzzPoint:
    """EC-sum along `axis` (removed from the batch shape); other batch axes
    are carried in parallel."""
    ndim = pts.X.ndim
    if axis % ndim != ndim - 1:
        pts = type(pts)(*(c.movedim(axis, -1) for c in pts))
    out = scans.fold(curve.xyzz_dadd, pts)
    return type(pts)(*(c[..., 0] for c in out))

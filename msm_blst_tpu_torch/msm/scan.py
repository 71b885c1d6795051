"""EC folds, scans and the segmented bucket reduction over xyzz batches
(port of msm_blst_tpu/msm/scan.py).

The folds and suffix scans replace the reference's serial bucket
integration loops (multi_scalar.c:281-344); the segmented reduction
(`bucket_impl="segmented"`) replaces its serial scatter loop (:421-463).

Segmented-reduction correctness (as the JAX module argues it): a key-sorted
stream is cut into contiguous chunks. In a chunk, runs strictly inside it
and not touching column 0 are complete and are stored at their key; the run
touching column 0 becomes the chunk's HEAD when it closes (infinity with the
run's key if the whole chunk is one run); the run open at the last column
is its TAIL. The interleaved (head, tail) stream is still key-sorted and is
reduced again, so the pieces of a key that spans chunks meet there. Each key
is stored by exactly one level, so the stores never collide.
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
    if pts.X.ndim == len(curve.F.lead) + 1:
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


def segmented_reduce_affine(curve, pts, signs, keys,
                            n_buckets: int) -> XyzzPoint:
    """Per-key sums of a key-sorted stream of signed affine points as an
    xyzz bucket array of n_buckets (bucket 0 included). `pts`: an
    AffinePoint (*F.lead, N) or its PackedRows32 rows (N, 2W); keys ascending,
    entries with key >= n_buckets are dropped. K5 levels first
    (cuda_scan.segmented_reduce, the JAX package's fused structure), then
    _segmented_reduce_xyzz."""
    return cuda_scan.segmented_reduce(curve, pts, signs, keys, n_buckets)


def _segmented_reduce_xyzz(curve, pts: XyzzPoint, keys, buckets: XyzzPoint,
                           n_buckets: int) -> XyzzPoint:
    """The remaining levels over an xyzz stream of at least two elements
    (the heads and tails of the affine level): more K5 levels
    (cuda_scan._run_level; pick_chunk columns below MIN_LEVEL_N, as the JAX
    package's unfused levels) until two elements are left, then the terminal
    two-element merge. Complete runs are stored into `buckets` in place.
    Returns `buckets`."""
    while keys.shape[-1] > 2:
        pts, keys = cuda_scan._run_level(curve, pts, None, keys, buckets,
                                         n_buckets)
    # terminal two-element stream: merge if one key, else store both
    a = XyzzPoint(*(x[..., :1] for x in pts))
    b = XyzzPoint(*(x[..., 1:] for x in pts))
    same = keys[:1] == keys[1:]
    second = curve.select(same, curve.xyzz_dadd(a, b), b)
    cuda_scan.store_points(buckets, torch.where(same, n_buckets, keys[:1]), a,
                           n_buckets)
    cuda_scan.store_points(buckets, keys[1:], second, n_buckets)
    return buckets

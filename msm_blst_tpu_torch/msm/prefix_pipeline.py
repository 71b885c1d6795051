"""Prefix-scan bucket accumulation (port of msm_blst_tpu/msm/prefix_pipeline.py).

With the digit stream sorted by bucket key, each bucket occupies a
contiguous range [left_k, right_k) of the stream, so its sum is a
difference of stream prefix sums:

    bucket[k] = P(right_k) - P(left_k),   P(i) = sum of the first i points,

and xyzz negation is free (negate Y). Pipeline:
  1. column-major index permutation (stream pos k*c + j -> lane k, column j),
  2. packed table row gather,
  3. level-1 prefix down each lane's columns (K3, cuda_scan),
  4. prefix scan over the n_ch chunk tails (K4, the block scan),
  5. the bucket boundaries (searchsorted), then each bucket's boundary
     prefix and difference in one K2 launch (cuda_point.bucket_diffs).

Steps 3 and 4 are the two levels of one scan, so a query's bucket sums lie
c + scan_depth(scan_schedule(n_ch)) adds deep; `stream_shape` picks the
level's (c, n_ch) for the least such depth within one wave of K3's lanes.
At 1024 elements and more that is not the JAX package's shape (a
power-of-two lane count of at most 8192, set by its TPU blocks), so the
local prefixes and tails there are other xyzz words than JAX's and the
bucket sums the same points; smaller streams keep its shape and words.

Big streams: `bucket_sums_prefix` splits a stream too large for the free
device memory into parts by position, merged with one K2 dadd each;
`bucket_sums_prefix_ranged` (engine.msm_bign) splits it by bucket range
into exact slices of the sorted stream (`segment_starts`).

Every index the pipeline forms is in range by construction: the stream is
padded to c*n_ch, positions come from searchsorted and a boundary at 0 is
infinity, so nothing relies on JAX's silent clamping of out-of-range
gathers.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..curves import cuda_point
from ..curves.ops import PackedRows32, XyzzPoint
from ..device import budget_bytes
from ..utils.scans import pick_chunk
from . import cuda_scan, scan
from .scan import prefix_scan_xyzz


def stream_shape(N: int):
    """(columns c, lanes n_ch) of the K3 level: stream pos k*c + j goes to
    lane k, column j. From 1024 elements on, the c of least modelled depth
    c + scan_depth(scan_schedule(n_ch)), n_ch = ceil(N / c) (K3's c serial
    adds down a lane, then K4's over the n_ch lane tails), with n_ch
    within one wave of K3's blocks (scan.FOLD_WAVE blocks of
    scan.FOLD_THREADS lanes, K4's wave) and c the fewest columns that n_ch
    lanes need; the fewer lanes on a tie. Smaller streams take the JAX
    package's pick_chunk columns, so that their words match it."""
    if N < 1024:
        c = pick_chunk(N)
        return c, -(-N // c)
    best = None  # (depth, n_ch, c)
    c = -(-N // (scan.FOLD_WAVE * scan.FOLD_THREADS))
    # K4 is at least one add deep, so no c from best's depth on can win
    while best is None or c < best[0]:
        n_ch = -(-N // c)
        cols = -(-N // n_ch)
        cand = (cols + scan.scan_depth(scan.scan_schedule(n_ch)), n_ch, cols)
        best = cand if best is None else min(best, cand)
        c += 1
    return best[2], best[1]


def column_major_streams(slots_s, signs_s, c: int, n_ch: int):
    """Pad the sorted streams to c*n_ch and permute to column-major order
    (index j*n_ch + k holds stream pos k*c + j). Pads land in the trailing
    chunks, past every bucket boundary."""
    N = slots_s.shape[0]
    pad = c * n_ch - N
    if pad:
        slots_s = torch.cat([slots_s, slots_s.new_zeros(pad)])
        signs_s = torch.cat([signs_s, signs_s.new_zeros(pad)])
    slots_cm = slots_s.reshape(n_ch, c).T.reshape(-1)
    signs_cm = signs_s.reshape(n_ch, c).T.reshape(-1)
    return slots_cm, signs_cm


def gather_rows(curve, table: PackedRows32, slots_cm, c: int, n_ch: int):
    """Gather packed table rows for the column-major stream: one whole-row
    gather, split into X and Y words. Returns ((c, n_ch, W), (c, n_ch, W))."""
    if not isinstance(table, PackedRows32):
        raise TypeError(f"gather_rows: expected PackedRows32, got "
                        f"{type(table).__name__}")
    W = curve.F.n_words
    g = table.XY.index_select(0, slots_cm.to(torch.int64))
    return (g[:, :W].reshape(c, n_ch, W).contiguous(),
            g[:, W:].reshape(c, n_ch, W).contiguous())


def buckets_from_boundaries(curve, local, tails: XyzzPoint, keys_s,
                            n_buckets: int, c: int, n_ch: int) -> XyzzPoint:
    """Assemble the dense bucket array from the prefix decomposition.
    `local`: int32 (c, n_ch, 4W) rows of the four xyzz coordinates.

    Only the RIGHT boundaries are searched: left_k (# elements with key <
    k) equals right_{k-1}, so P(left_k) is P(right) shifted by one bucket.
    The scan of the lane tails (K4) and the boundaries' searchsorted, then
    the sums in one launch of K2 (cuda_point.bucket_diffs; its plain twin
    on CPU tensors)."""
    incl = prefix_scan_xyzz(curve, tails)
    kq = torch.arange(n_buckets, dtype=keys_s.dtype, device=keys_s.device)
    right = torch.searchsorted(keys_s, kq, right=True, out_int32=True)
    return cuda_point.bucket_diffs(curve, right, local, incl, c, n_ch)


def element_bytes(curve) -> int:
    """Device bytes one stream element costs in _bucket_sums_prefix_single
    at its peak: its gathered table row (8W B, W = curve.F.n_words) and the
    row's X and Y split out of it (8W B), its level row of four xyzz
    coordinates (16W B), and its stream words (the column-major slot and
    sign, the int64 gather index: 24 B at most)."""
    return 32 * curve.F.n_words + 24


def chunks_for(curve, keys_s) -> int:
    """How many parts the key-sorted stream `keys_s` takes so that one
    part's _bucket_sums_prefix_single fits the device memory free now
    (device.budget_bytes); one for CPU tensors."""
    N = keys_s.shape[0]
    if keys_s.device.type == "cpu" or N == 0:
        return 1
    fit = max(1, budget_bytes(keys_s.device) // element_bytes(curve))
    return -(-N // fit)


def bucket_sums_prefix(curve, table, slots_s, signs_s, keys_s,
                       n_buckets: int, chunks: Optional[int] = None
                       ) -> XyzzPoint:
    """Per-key sums of a key-sorted signed digit stream, as a dense xyzz
    bucket array of n_buckets (bucket 0 included).

    A stream too large for one pass (chunks_for; `chunks` sets the count)
    is split by position into that many consecutive parts, as the JAX
    package does (prefix_pipeline.py:247-289): each part is itself
    key-sorted, so its bucket array comes from the same boundary trick, and
    the parts' arrays merge with one bucket-wide K2 dadd each. CPU tensors
    take one pass unless `chunks` is given."""
    N = keys_s.shape[0]
    chunks = chunks or chunks_for(curve, keys_s)
    if chunks <= 1 or N == 0:
        return _bucket_sums_prefix_single(curve, table, slots_s, signs_s,
                                          keys_s, n_buckets)
    part = -(-N // chunks)
    acc = None
    for lo in range(0, N, part):
        sl = slice(lo, lo + part)
        b = _bucket_sums_prefix_single(curve, table, slots_s[sl], signs_s[sl],
                                       keys_s[sl], n_buckets)
        acc = b if acc is None else curve.xyzz_dadd(acc, b)
    return acc


def segment_starts(keys_s, n_buckets: int, n_chunks: int):
    """Where each bucket-range chunk starts in the key-sorted stream: chunk
    k owns buckets [k*W, (k+1)*W), W = ceil(n_buckets / n_chunks), and its
    stream segment is [starts[k], starts[k+1]). Returns (int32[n_chunks +
    1] on the stream's device, W)."""
    W = -(-n_buckets // n_chunks)
    marks = torch.arange(n_chunks + 1, dtype=keys_s.dtype,
                         device=keys_s.device) * W
    return torch.searchsorted(keys_s, marks, out_int32=True), W


def bucket_ranges(curve, table, slots_s, signs_s, keys_s, starts, W: int):
    """Each bucket-range chunk's W buckets in turn: chunk k runs the prefix
    pipeline on its exact slice [starts[k], starts[k+1]) of the key-sorted
    stream with keys - k*W. `starts`: host ints (segment_starts, read
    once). Each slice is as long as its buckets' digits: there is no
    padding, no sentinel key and no shared segment length to round up."""
    for k in range(len(starts) - 1):
        sl = slice(starts[k], starts[k + 1])
        yield _bucket_sums_prefix_single(curve, table, slots_s[sl],
                                         signs_s[sl], keys_s[sl] - k * W, W)


def bucket_sums_prefix_ranged(curve, table, slots_s, signs_s, keys_s,
                              n_buckets: int, starts) -> XyzzPoint:
    """bucket_sums_prefix with the stream split by BUCKET RANGE (port of
    prefix_pipeline.py:291-345): chunk k computes only its own W buckets,
    so the boundary work totals one pass over the buckets and the chunks'
    disjoint arrays concatenate without a merge. `starts`: the K + 1 host
    ints of segment_starts(keys_s, n_buckets, K)."""
    W = -(-n_buckets // (len(starts) - 1))
    parts = list(bucket_ranges(curve, table, slots_s, signs_s, keys_s,
                               starts, W))
    return XyzzPoint(*(torch.cat(cs, dim=-1)[..., :n_buckets]
                       for cs in zip(*parts)))


def _bucket_sums_prefix_single(curve, table, slots_s, signs_s, keys_s,
                               n_buckets: int) -> XyzzPoint:
    N = keys_s.shape[0]
    if N == 0:  # an empty bucket range: no level to launch
        return curve.xyzz_inf((n_buckets,), keys_s.device)
    c, n_ch = stream_shape(N)
    slots_cm, signs_cm = column_major_streams(slots_s, signs_s, c, n_ch)
    rx, ry = gather_rows(curve, table, slots_cm, c, n_ch)
    local, tails = cuda_scan.affine_prefix_level(
        curve, rx, ry, signs_cm.reshape(c, n_ch))
    return buckets_from_boundaries(curve, local, tails, keys_s, n_buckets,
                                   c, n_ch)

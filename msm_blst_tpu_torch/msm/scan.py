"""EC folds, scans and the segmented bucket reduction over xyzz batches
(port of msm_blst_tpu/msm/scan.py); K9, the segmented xyzz fold
(csrc/fold.cu for G1, csrc/fold_g2.cu for G2), and K4, the block scan
(csrc/block_scan.cu, csrc/block_scan_g2.cu), each with its plain twin.

The folds and suffix scans replace the reference's serial bucket
integration loops (multi_scalar.c:281-344); the segmented reduction
(`bucket_impl="segmented"`) replaces its serial scatter loop (:421-463).

Every fold goes through `fold_segments`: the sums of many segments of one
stream at once. K9 replaces msm_blst_tpu/curves/pallas_point.py
_kernel(curve, "dadd") as msm_blst_tpu/utils/scans.py fold calls it, one
formula launch a column. It sums a tile of FOLD_THREADS * k elements a
block, a serial stage then a tree, pass after pass (`fold_tiles` picks k
and cuts the tiles on the host). The terms associate otherwise than in the
JAX fold: the sums are the same points, not the same xyzz words.

Every xyzz prefix or suffix scan goes through `prefix_scan_xyzz`. K4
replaces msm_blst_tpu/msm/pallas_scan.py _scan_kernel with the chunk-tail
scan and carry around it: tiles of FOLD_THREADS * k elements, k a thread
in order, a block scan of the thread sums, one block over the tile totals,
then each thread's k sums from its offset (`scan_schedule` picks k). Its
sums associate otherwise than JAX's too.

Segmented-reduction correctness (as the JAX module argues it): a key-sorted
stream is cut into contiguous chunks. In a chunk, runs strictly inside it
and not touching column 0 are complete and are stored at their key; the run
touching column 0 becomes the chunk's HEAD when it closes (infinity with the
run's key if the whole chunk is one run); the run open at the last column
is its TAIL. The interleaved (head, tail) stream is still key-sorted; the
JAX package reduces it again by more such levels, the port by one segmented
scan (K5's second part, cuda_scan.seg_scan), so the pieces of a key that
spans chunks meet there. Each key is stored once, by the level or by the
scan, so the stores never collide.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..curves.ops import XyzzPoint
from ..kernels import CURVE_KERNELS, check_cuda, on_cpu, ptr
from ..utils import scans

# K9's and K4's block (csrc/fold.cuh and block_scan.cuh THREADS), and the
# blocks that fill the H100 in one wave: 132 SMs, two blocks of 128 threads
# an SM, the occupancy of K4's and K9's own kernels at 255 registers a
# thread (K3 is built for it too).
FOLD_THREADS = 128
FOLD_WAVE = 132 * 2


class FoldPass(NamedTuple):
    """One K9 launch: k elements a thread in the serial stage, and the
    tiles, int64 (n_tiles, 2): [start, end) of the pass's input stream.
    Tile t's partial is element t of the next pass's input."""

    k: int
    tiles: torch.Tensor


def _tiles_per_segment(lengths, k: int):
    return np.maximum(1, -(-lengths // (FOLD_THREADS * k)))


def fold_schedule(offsets) -> list:
    """The passes of a fold of segments [offsets[g], offsets[g+1]) on the
    host, as (k, tiles) numpy pairs. A segment takes max(1, ceil(length /
    (FOLD_THREADS * k))) tiles (an empty one a tile of nothing: infinity),
    and k is the fewest elements a thread that keep a pass within one
    FOLD_WAVE of tiles (or one tile a segment, if there are more segments).
    A segment's partials are the segment in the next pass; passes run until
    each segment is one partial."""
    offs = np.asarray(offsets, dtype=np.int64)
    starts, lengths = offs[:-1], np.diff(offs)
    passes = []
    while True:
        k = max(1, -(-int(lengths.sum()) // (FOLD_WAVE * FOLD_THREADS)))
        while _tiles_per_segment(lengths, k).sum() > max(FOLD_WAVE, len(lengths)):
            k += 1
        span = FOLD_THREADS * k
        n_t = _tiles_per_segment(lengths, k)
        first = np.cumsum(n_t) - n_t  # each segment's first tile
        seg = np.repeat(np.arange(len(n_t)), n_t)
        lo = starts[seg] + (np.arange(int(n_t.sum())) - first[seg]) * span
        hi = np.minimum(lo + span, (starts + lengths)[seg])
        passes.append((k, np.stack([lo, hi], axis=1)))
        if (n_t == 1).all():
            return passes
        starts, lengths = first, n_t


@functools.lru_cache(maxsize=64)
def _fold_tiles(offsets: tuple, device) -> tuple:
    return tuple(FoldPass(k, torch.as_tensor(t, device=device))
                 for k, t in fold_schedule(offsets))


def fold_tiles(offsets, device=None) -> tuple:
    """fold_schedule's passes with their tile tables on `device`, made once
    for each (offsets, device) and kept."""
    return _fold_tiles(tuple(int(o) for o in offsets), device)


def _no_segments(curve, pts: XyzzPoint) -> XyzzPoint:
    z = pts.X.new_zeros(curve.F.lead + (0,))
    return XyzzPoint(z, z, z, z)


def _segment_elems(src: XyzzPoint, index, pos, valid) -> XyzzPoint:
    """Elements pos (int64, any shape) of a (*lead, n) stream, read through
    `index` if given; infinity where not `valid`."""
    if not bool(valid.any()):
        z = src.X.new_zeros(src.X.shape[:-1] + pos.shape)
        return XyzzPoint(z, z, z, z)
    at = torch.where(valid, pos, 0)
    if index is not None:
        at = index[at]
    at = at.reshape(-1)
    return XyzzPoint(*(torch.where(valid, c[..., at].reshape(
        c.shape[:-1] + pos.shape), 0) for c in src))


def _dadd_lanes(curve, a: XyzzPoint, b: XyzzPoint) -> XyzzPoint:
    """The plain dadd of (*lead, *batch) points. Where an operand is
    infinity the formula's answer is its case analysis alone (b if a is
    infinity, else a), so only the lanes where both are finite run the
    formula: the same words, for the cost of the real adds (most lanes of
    a short segment's tile are infinity)."""
    lead = curve.F.lead
    shape = curve.bshape(a.X)
    a, b = (XyzzPoint(*(c.reshape(lead + (-1,)) for c in p)) for p in (a, b))
    a_inf, b_inf = curve.xyzz_is_inf(a), curve.xyzz_is_inf(b)
    out = curve.select(a_inf, b, a)
    both = (~(a_inf | b_inf)).nonzero()[:, 0]
    if len(both):
        added = curve.xyzz_dadd_body(curve.take(a, both), curve.take(b, both),
                                     F=curve.F.plain)
        for o, c in zip(out, added):
            o[..., both] = c
    return XyzzPoint(*(c.reshape(lead + shape) for c in out))


def fold_segments_plain(curve, pts: XyzzPoint, offsets,
                        index=None) -> XyzzPoint:
    """Plain K9, batched over every tile of a pass, with the kernel's
    tiles, k, operand order and passes: thread j of a tile [start, end)
    starts from element start + j (infinity past end) and adds elements
    start + j + i * FOLD_THREADS, i = 1..k-1, that lie before end; then for
    s = FOLD_THREADS/2 .. 1 thread j < s adds thread j + s's sum to its own.
    On the card it equals K9 word for word."""
    if len(offsets) == 1:
        return _no_segments(curve, pts)
    passes = fold_tiles(offsets, pts.X.device)
    T = FOLD_THREADS
    lane = torch.arange(T, device=pts.X.device)
    src = pts
    for k, t in passes:
        lo, hi = t[:, :1], t[:, 1:]
        acc = None
        for i in range(k):
            pos = lo + lane + i * T
            valid = pos < hi
            e = _segment_elems(src, index, pos, valid)
            acc = e if acc is None else curve.select(
                valid, _dadd_lanes(curve, acc, e), acc)
        s = T // 2
        while s >= 1:
            acc = _dadd_lanes(curve, XyzzPoint(*(c[..., :s] for c in acc)),
                              XyzzPoint(*(c[..., s:2 * s] for c in acc)))
            s //= 2
        src, index = XyzzPoint(*(c[..., 0] for c in acc)), None
    return src


def fold_segments(curve, pts: XyzzPoint, offsets, index=None) -> XyzzPoint:
    """The sum of each segment g of a 1-D xyzz batch `pts` (*F.lead, M):
    pts[index[offsets[g]:offsets[g+1]]], or pts[offsets[g]:offsets[g+1]]
    when `index` (int64) is None. `offsets`: G + 1 ascending host integers.
    An empty segment sums to infinity. Returns an XyzzPoint (*F.lead, G).

    CUDA tensors go through K9, one launch a pass; CPU tensors take
    fold_segments_plain."""
    if on_cpu(*pts):
        return fold_segments_plain(curve, pts, offsets, index)
    if len(offsets) == 1:
        return _no_segments(curve, pts)
    dev = pts.X.device
    passes = fold_tiles(offsets, dev)
    kernel = CURVE_KERNELS[curve.name]["xyzz_fold"]
    lead, W = curve.F.lead, curve.F.n_words
    src = [c.contiguous().reshape(W, c.shape[-1]) for c in pts]
    check_cuda(kernel.symbol, src)
    for t in ([] if index is None else [index]) + [p.tiles for p in passes]:
        if t.device != dev or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{kernel.symbol}: index and tiles must be "
                             f"contiguous int64 tensors on {dev}")
    for k, t in passes:
        n_t = t.shape[0]
        outs = [torch.empty((W, n_t), dtype=torch.int32, device=dev)
                for _ in range(4)]
        if n_t:
            kernel(*map(ptr, src), None if index is None else ptr(index),
                   ptr(t), *map(ptr, outs), src[0].shape[1], n_t, k)
        src, index = outs, None
    return XyzzPoint(*(c.reshape(lead + (-1,)) for c in src))


def fold_xyzz(curve, pts: XyzzPoint) -> XyzzPoint:
    """Sum along the last axis -> batch of 1."""
    out = scan_fold_axis(curve, pts, -1)
    return XyzzPoint(*(c.unsqueeze(-1) for c in out))


class ScanSchedule(NamedTuple):
    """K4's launch shape for a stream of N elements: k elements a thread,
    n_tiles tiles of FOLD_THREADS * k elements, and k_carry tile totals a
    thread in the carry pass (0 when one tile holds the stream)."""

    k: int
    n_tiles: int
    k_carry: int


def scan_depth(s: ScanSchedule) -> int:
    """Adds on K4's longest chain: a thread's k - 1, the block scan's
    log2(FOLD_THREADS), its k emissions; with more than one tile also the
    carry pass (the same three over the totals) and the offset's add."""
    lg = FOLD_THREADS.bit_length() - 1
    depth = (s.k - 1) + lg + s.k
    if s.n_tiles > 1:
        depth += (s.k_carry - 1) + lg + s.k_carry + 1
    return depth


@functools.lru_cache(maxsize=256)
def scan_schedule(N: int) -> ScanSchedule:
    """The schedule of least scan_depth whose tiles fit in one FOLD_WAVE
    (the smaller k on a tie). Every k has a depth of at least 2k - 1 +
    log2(FOLD_THREADS), which ends the search."""
    T = FOLD_THREADS
    lg = T.bit_length() - 1
    k = max(1, -(-N // (T * FOLD_WAVE)))
    best = None
    while best is None or 2 * k - 1 + lg < scan_depth(best):
        n_tiles = max(1, -(-N // (T * k)))
        s = ScanSchedule(k, n_tiles, 0 if n_tiles == 1 else -(-n_tiles // T))
        if best is None or scan_depth(s) < scan_depth(best):
            best = s
        if n_tiles == 1:
            break
        k += 1
    return best


def _shifted(pts: XyzzPoint) -> XyzzPoint:
    """Each element replaced by its predecessor along the last axis, the
    first by infinity."""
    return XyzzPoint(*(torch.cat([c.new_zeros(c.shape[:-1] + (1,)),
                                  c[..., :-1]], dim=-1) for c in pts))


def _block_scan(curve, acc: XyzzPoint) -> XyzzPoint:
    """The kernel's Kogge-Stone scan along the last axis (the threads): at
    d = 1, 2, .., T/2 thread j >= d adds thread j - d's sum in front of its
    own."""
    d = 1
    while d < acc.X.shape[-1]:
        added = _dadd_lanes(curve, XyzzPoint(*(c[..., :-d] for c in acc)),
                            XyzzPoint(*(c[..., d:] for c in acc)))
        acc = XyzzPoint(*(torch.cat([c[..., :d], a], dim=-1)
                          for c, a in zip(acc, added)))
        d *= 2
    return acc


def _thread_elems(pts: XyzzPoint, k: int, n_tiles: int):
    """(*lead, N) -> the k elements of every thread, a list of k
    XyzzPoints of (*lead, n_tiles, FOLD_THREADS); infinity past N."""
    N, T = pts.X.shape[-1], FOLD_THREADS
    x = XyzzPoint(*(scans.pad_last(c, n_tiles * T * k - N)
                    .reshape(c.shape[:-1] + (n_tiles, T, k)) for c in pts))
    return [XyzzPoint(*(c[..., e] for c in x)) for e in range(k)]


def _thread_sums(curve, elems) -> XyzzPoint:
    acc = elems[0]
    for e in elems[1:]:
        acc = _dadd_lanes(curve, acc, e)
    return acc


def _emit(curve, off: XyzzPoint, elems, N: int) -> XyzzPoint:
    """From each thread's offset, its k inclusive sums in order, as the
    stream (*lead, N)."""
    outs = []
    for e in elems:
        off = _dadd_lanes(curve, off, e)
        outs.append(off)
    return XyzzPoint(*(torch.stack(cs, dim=-1).reshape(cs[0].shape[:-2] + (-1,))
                       [..., :N] for cs in zip(*outs)))


def _tile_scan_plain(curve, pts: XyzzPoint, k: int) -> XyzzPoint:
    """The kernel's one-block scan of N <= FOLD_THREADS * k elements: thread
    sums, block scan, then each thread's sums from thread j - 1's prefix.
    Only the threads that hold an element are computed: a thread's sums
    read no thread after it, so the others cannot change them."""
    used = -(-pts.X.shape[-1] // k)
    elems = [XyzzPoint(*(c[..., :used] for c in e))
             for e in _thread_elems(pts, k, 1)]
    incl = _block_scan(curve, _thread_sums(curve, elems))
    return _emit(curve, _shifted(incl), elems, pts.X.shape[-1])


def prefix_scan_xyzz_plain(curve, pts: XyzzPoint) -> XyzzPoint:
    """Plain K4, batched over every tile and thread, with the kernel's
    schedule and the operands of every add in its order (the earlier sum
    first): one tile is _tile_scan_plain; more take the tiles' thread sums
    and block scans (up), _tile_scan_plain over the tile totals with k_carry
    (carry), then each thread's k sums from carry[t - 1] + prefix[t, j - 1]
    (down). On the card it equals K4 word for word."""
    N = pts.X.shape[-1]
    k, n_tiles, k_carry = scan_schedule(N)
    if n_tiles == 1:
        return _tile_scan_plain(curve, pts, k)
    elems = _thread_elems(pts, k, n_tiles)
    part = _block_scan(curve, _thread_sums(curve, elems))
    carry = _tile_scan_plain(curve, XyzzPoint(*(c[..., -1] for c in part)),
                             k_carry)
    before = XyzzPoint(*(c.unsqueeze(-1).expand(part.X.shape).contiguous()
                         for c in _shifted(carry)))
    off = _dadd_lanes(curve, before, _shifted(part))
    return _emit(curve, off, elems, N)


def prefix_scan_xyzz(curve, pts: XyzzPoint) -> XyzzPoint:
    """Inclusive prefix sums of a 1-D xyzz batch (*F.lead, N). CUDA tensors
    go through K4, one call (one kernel launch for one tile, three for
    more); CPU tensors take prefix_scan_xyzz_plain."""
    N = pts.X.shape[-1]
    if N == 0:
        return XyzzPoint(*(c.clone() for c in pts))
    if on_cpu(*pts):
        return prefix_scan_xyzz_plain(curve, pts)
    kernel = CURVE_KERNELS[curve.name]["xyzz_prefix_scan"]
    W = curve.F.n_words
    if any(tuple(c.shape) != curve.F.lead + (N,) for c in pts):
        raise ValueError(f"{kernel.symbol}: expected a 1-D batch of "
                         f"{curve.F.lead + (N,)} coordinates")
    src = [c.contiguous() for c in pts]
    check_cuda(kernel.symbol, src)
    k, n_tiles, k_carry = scan_schedule(N)
    outs = [torch.empty_like(c) for c in src]
    scratch = None if n_tiles == 1 else torch.empty(
        4 * W * n_tiles * (FOLD_THREADS + 2), dtype=torch.int32,
        device=src[0].device)
    kernel(*map(ptr, src + outs), None if scratch is None else ptr(scratch),
           N, n_tiles, k, k_carry)
    return XyzzPoint(*outs)


def suffix_scan_xyzz(curve, pts: XyzzPoint) -> XyzzPoint:
    """Inclusive suffix sums S_i = sum_{j>=i} pts[j] of a 1-D xyzz batch
    (*F.lead, N): prefix_scan_xyzz on the flipped stream (torch.flip stands
    in for JAX's reversed slice)."""
    if pts.X.ndim != len(curve.F.lead) + 1:
        raise ValueError(f"suffix_scan_xyzz: expected a 1-D batch, got "
                         f"{tuple(pts.X.shape)}")
    flipped = XyzzPoint(*(torch.flip(c, dims=(-1,)) for c in pts))
    return XyzzPoint(*(torch.flip(c, dims=(-1,))
                       for c in prefix_scan_xyzz(curve, flipped)))


def scan_fold_axis(curve, pts: XyzzPoint, axis: int) -> XyzzPoint:
    """EC-sum along `axis` (removed from the batch shape); other batch axes
    are carried in parallel, as equal-length segments of one fold."""
    ndim = pts.X.ndim
    if axis % ndim != ndim - 1:
        pts = XyzzPoint(*(c.movedim(axis, -1) for c in pts))
    lead = curve.F.lead
    batch, M = tuple(pts.X.shape[len(lead):-1]), pts.X.shape[-1]
    G = math.prod(batch)
    flat = XyzzPoint(*(c.contiguous().reshape(lead + (G * M,)) for c in pts))
    offsets = range(0, G * M + 1, M) if M else [0] * (G + 1)
    out = fold_segments(curve, flat, offsets)
    return XyzzPoint(*(c.reshape(lead + batch) for c in out))


def segmented_reduce_affine(curve, pts, signs, keys,
                            n_buckets: int) -> XyzzPoint:
    """Per-key sums of a key-sorted stream of signed affine points as an
    xyzz bucket array of n_buckets (bucket 0 included). `pts`: an
    AffinePoint (*F.lead, N) or its PackedRows32 rows (N, 2W); keys ascending,
    entries with key >= n_buckets are dropped. K5: its affine level, then
    its segmented scan over the level's heads and tails
    (cuda_scan.segmented_reduce)."""
    from . import cuda_scan

    return cuda_scan.segmented_reduce(curve, pts, signs, keys, n_buckets)

"""K3 and K5: the level kernels of the two bucket pipelines
(csrc/scan.cu, csrc/seg.cu) and their plain twins.

Each kernel has a G1 and a G2 instance (csrc/scan.cu and seg.cu,
csrc/scan_g2.cu and seg_g2.cu), chosen by the curve. Coordinates keep the
field's leading axes F.lead — (12,) for G1, (2, 12) for G2 — in front of the
lane axis, as JAX's pallas_scan `_lead`; rows hold W = F.n_words words per
coordinate (12 or 24).

K3 `affine_prefix_level` replaces msm_blst_tpu/msm/pallas_scan.py
_affine_prefix_kernel (via affine_prefix_level): the level-1 inclusive
prefix of a signed affine stream down `c` columns per lane, emitting every
local prefix as a row (X||Y||ZZZ||ZZ words) and each lane's xyzz tail.

K5 `seg_level` replaces pallas_scan.py _seg_kernel (via _run_level and
segmented_reduce): one level of the segmented head/tail/emission bucket
reduction, affine (level 1) or xyzz (later levels). Complete runs go
straight into the bucket array, in place. `segmented_reduce` runs every
level through K5, with the level shapes of the JAX package's
pallas_scan.segmented_reduce: `_shape_stream` while the stream holds at
least MIN_LEVEL_N elements, the `pick_chunk` columns of its unfused
scan._segmented_reduce_xyzz below that, then the terminal two-element
merge. The TPU's lane slicing (_slice_lanes and its VMEM budgets) and its
opt-in (`available`) are not carried over: one launch takes all lanes.

The xyzz prefix scan (pallas_scan.py _scan_kernel and the chunk-tail carry
around it) is K4, the block scan of msm/scan.py `prefix_scan_xyzz`.

On a CUDA tensor every call goes through its kernel: the TPU launch-cost
thresholds (MIN_SCAN_N, prefix_available) gate nothing here. CPU tensors
take the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.ops import AffinePoint, PackedRows32, XyzzPoint
from ..kernels import CURVE_KERNELS, check_cuda, on_cpu, ptr
from ..utils import scans

# K5 levels run while the stream holds at least this many elements
MIN_LEVEL_N = 1024


def _shape_stream(N: int, c_target: int = 32):
    """(columns, lanes) for a stream of N elements, as the JAX package
    picks them: lanes a power of two >= 128 (its TPU block), ~c_target
    columns."""
    n_ch = max(128, 1 << max(int(np.floor(np.log2(max(N // c_target, 1)))), 0))
    return max(2, -(-N // n_ch)), n_ch


def _lanes_last(curve, x):
    """(c, n_ch, W) rows -> (c, *F.lead, n_ch) coordinates."""
    c, n_ch, _ = x.shape
    return x.permute(0, 2, 1).reshape((c,) + curve.F.lead + (n_ch,))


def _empty(curve, n: int, device):
    """Four uninitialised (*F.lead, n) coordinates."""
    return [torch.empty(curve.F.lead + (n,), dtype=torch.int32, device=device)
            for _ in range(4)]


# ---- K3 -----------------------------------------------------------------------


def affine_prefix_level_plain(curve, rows_x, rows_y, sgn_cols):
    """Plain K3: rows (c, n_ch, W) int32 x2, signs (c, n_ch) ->
    (local rows int32 (c, n_ch, 4W), tails XyzzPoint of (*F.lead, n_ch))."""
    F = curve.F.plain
    c, n_ch, W = rows_x.shape
    X = _lanes_last(curve, rows_x)
    Y = _lanes_last(curve, rows_y)
    sub = sgn_cols != 0
    run = curve.xyzz_from_affine(AffinePoint(X[0], Y[0]), negate=sub[0])
    locs = [run]
    for j in range(1, c):
        run = curve.xyzz_dadd_affine_body(run, AffinePoint(X[j], Y[j]),
                                          subtract=sub[j], F=F)
        locs.append(run)
    local = torch.cat([torch.stack([p[i] for p in locs]).reshape(c, W, n_ch)
                       for i in range(4)], dim=1)  # (c, 4W, n_ch)
    return local.permute(0, 2, 1).contiguous(), run


def affine_prefix_level(curve, rows_x, rows_y, sgn_cols):
    """Level-1 prefix over gathered table rows (c, n_ch, W) x2 and signs
    (c, n_ch). Returns (local rows int32 (c, n_ch, 4W) — the four xyzz
    coordinates per stream element — and tails XyzzPoint of (*F.lead,
    n_ch))."""
    if on_cpu(rows_x):
        return affine_prefix_level_plain(curve, rows_x, rows_y, sgn_cols)
    c, n_ch, W = rows_x.shape
    if (W != curve.F.n_words or rows_y.shape != rows_x.shape
            or tuple(sgn_cols.shape) != (c, n_ch)):
        raise ValueError("affine_prefix_level: shapes "
                         f"{tuple(rows_x.shape)} {tuple(rows_y.shape)} "
                         f"{tuple(sgn_cols.shape)}")
    sgn = sgn_cols.to(torch.int32).contiguous()
    check_cuda("affine_prefix_level", (rows_x, rows_y, sgn))
    local = torch.empty((c, n_ch, 4 * W), dtype=torch.int32,
                        device=rows_x.device)
    tails = _empty(curve, n_ch, rows_x.device)
    CURVE_KERNELS[curve.name]["affine_prefix_level"](
        ptr(rows_x), ptr(rows_y), ptr(sgn), ptr(local), *map(ptr, tails), c,
        n_ch)
    return local, XyzzPoint(*tails)


# ---- K5 -----------------------------------------------------------------------


def bucket_array(curve, n_buckets: int, device) -> XyzzPoint:
    """An all-infinity xyzz bucket array for in-place stores: four distinct
    (*F.lead, n_buckets) tensors (curve.xyzz_inf shares one zero tensor)."""
    return XyzzPoint(*(torch.zeros(curve.F.lead + (n_buckets,),
                                   dtype=torch.int32, device=device)
                       for _ in range(4)))


def store_points(buckets: XyzzPoint, keys, pts: XyzzPoint,
                 n_buckets: int) -> None:
    """buckets[:, k] = pts[:, i] in place for every i whose key k is a real
    bucket; keys outside [0, n_buckets) (pads, "no emission") are masked
    out, never handed to the index store. Real keys are unique."""
    keep = (keys >= 0) & (keys < n_buckets)
    idx = keys[keep].to(torch.int64)
    for bc, pc in zip(buckets, pts):
        bc[..., idx] = pc[..., keep]


def seg_level_plain(curve, cols, signs, keys, buckets: XyzzPoint,
                    n_buckets: int):
    """Plain K5, the same contract: `cols` is (rows_x, rows_y) of
    (c, n_ch, W) with `signs` (c, n_ch) (affine), or an XyzzPoint of
    (c, *F.lead, n_ch) with signs None; keys (c, n_ch). Complete runs are
    stored into `buckets` in place. Returns (head, tail) XyzzPoints of
    (*F.lead, n_ch) and (head_key, tail_key) of (n_ch,)."""
    F = curve.F.plain
    c, n_ch = keys.shape
    if signs is not None:
        X, Y = (_lanes_last(curve, r) for r in cols)
        sub = signs != 0

        def lift(j):
            return curve.xyzz_from_affine(AffinePoint(X[j], Y[j]),
                                          negate=sub[j])

        def add(run, j):
            return curve.xyzz_dadd_affine_body(run, AffinePoint(X[j], Y[j]),
                                               subtract=sub[j], F=F)
    else:
        def lift(j):
            return XyzzPoint(*(x[j] for x in cols))

        def add(run, j):
            return curve.xyzz_dadd_body(run, lift(j), F=F)

    run = lift(0)
    head = curve.xyzz_inf((n_ch,), keys.device)
    run_key = head_key = keys[0]
    from0 = torch.ones(n_ch, dtype=torch.bool, device=keys.device)
    for j in range(1, c):
        ky = keys[j]
        closing = ky != run_key
        cap = closing & from0
        head = curve.select(cap, run, head)
        head_key = torch.where(cap, run_key, head_key)
        store_points(buckets, torch.where(closing & ~from0, run_key, n_buckets),
                     run, n_buckets)
        run = curve.select(closing, lift(j), add(run, j))
        from0 = from0 & ~closing
        run_key = ky
    return head, run, torch.where(from0, run_key, head_key), run_key


def seg_level(curve, cols, signs, keys, buckets: XyzzPoint, n_buckets: int):
    """One segmented level (see seg_level_plain for the contract): K5 for
    CUDA tensors, the plain version for CPU tensors."""
    if on_cpu(keys):
        return seg_level_plain(curve, cols, signs, keys, buckets, n_buckets)
    lead, W = curve.F.lead, curve.F.n_words
    c, n_ch = keys.shape
    dev = keys.device
    keys = keys.to(torch.int32).contiguous()
    bk = list(buckets)
    if any(tuple(b.shape) != lead + (n_buckets,) for b in bk):
        raise ValueError(f"seg_level: buckets must be {lead + (n_buckets,)}")
    head = _empty(curve, n_ch, dev)
    tail = _empty(curve, n_ch, dev)
    hk = torch.empty(n_ch, dtype=torch.int32, device=dev)
    tk = torch.empty_like(hk)
    outs = [*map(ptr, bk), n_buckets, *map(ptr, head + tail), ptr(hk), ptr(tk),
            c, n_ch]
    if signs is not None:
        rx, ry = (r.contiguous() for r in cols)
        sg = signs.to(torch.int32).contiguous()
        if rx.shape != (c, n_ch, W) or ry.shape != rx.shape or sg.shape != keys.shape:
            raise ValueError("seg_level: affine rows must be (c, n_ch, W) "
                             "with signs and keys (c, n_ch)")
        check_cuda("seg_level_affine", [rx, ry, sg, keys] + bk)
        CURVE_KERNELS[curve.name]["seg_level_affine"](
            ptr(rx), ptr(ry), ptr(sg), ptr(keys), *outs)
    else:
        ins = [x.contiguous() for x in cols]
        if any(tuple(x.shape) != (c,) + lead + (n_ch,) for x in ins):
            raise ValueError("seg_level: xyzz coordinates must be "
                             "(c, *F.lead, n_ch)")
        check_cuda("seg_level_xyzz", ins + [keys] + bk)
        CURVE_KERNELS[curve.name]["seg_level_xyzz"](*map(ptr, ins),
                                                     ptr(keys), *outs)
    return XyzzPoint(*head), XyzzPoint(*tail), hk, tk


def level_cols(curve, pts, signs, keys, n_buckets: int):
    """seg_level's inputs for one level over a key-sorted stream of N
    elements: `pts` is the signed affine stream (signs given) as an
    AffinePoint (*F.lead, N) or its PackedRows32 rows (N, 2W), or an xyzz
    stream XyzzPoint (*F.lead, N). Lane k takes elements k*c .. k*c + c-1;
    pads are infinity with key n_buckets. Returns (cols, signs cols or None,
    keys cols (c, n_ch)).

    Streams below MIN_LEVEL_N, for which the JAX package runs no fused level,
    take the chunking of its unfused level (scan._segmented_reduce_xyzz:
    pick_chunk columns) instead of padding to 128 lanes."""
    W = curve.F.n_words
    N = keys.shape[0]
    if N >= MIN_LEVEL_N:
        c, n_ch = _shape_stream(N)
    else:
        c = scans.pick_chunk(N)
        n_ch = -(-N // c)
    pad = n_ch * c - N

    def to_cols(x):  # (N,) -> (c, n_ch); column j holds elements k*c + j
        return x.reshape(n_ch, c).T.contiguous()

    kcols = to_cols(torch.cat([keys.to(torch.int32),
                               keys.new_full((pad,), n_buckets, dtype=torch.int32)]))
    if signs is not None:
        rows = pts.XY if isinstance(pts, PackedRows32) else curve.to_rows32(pts).XY
        rows = torch.cat([rows, rows.new_zeros((pad, 2 * W))])
        g = rows.reshape(n_ch, c, 2 * W).transpose(0, 1)
        cols = (g[..., :W].contiguous(), g[..., W:].contiguous())
        scols = to_cols(scans.pad_last(signs.to(torch.int32), pad))
    else:
        cols = XyzzPoint(*(scans.pad_last(x, pad)
                           .reshape(curve.F.lead + (n_ch, c)).movedim(-1, 0)
                           .contiguous() for x in pts))
        scols = None
    return cols, scols, kcols


def _run_level(curve, pts, signs, keys, buckets: XyzzPoint, n_buckets: int):
    """One K5 level over a key-sorted stream (see level_cols). Complete runs
    go into `buckets`; returns the next stream: heads and tails interleaved
    (still key-sorted), as (XyzzPoint (*F.lead, 2 n_ch), keys)."""
    head, tail, hk, tk = seg_level(
        curve, *level_cols(curve, pts, signs, keys, n_buckets), buckets,
        n_buckets)
    lvl_pt = XyzzPoint(*(torch.stack([h, t], dim=-1)
                         .reshape(curve.F.lead + (-1,))
                         for h, t in zip(head, tail)))
    return lvl_pt, torch.stack([hk, tk], dim=-1).reshape(-1)


def segmented_reduce(curve, pts, signs, keys, n_buckets: int) -> XyzzPoint:
    """Per-key sums of a key-sorted signed affine stream (see level_cols for
    `pts`) as an xyzz bucket array of n_buckets: the affine K5 level, then
    scan._segmented_reduce_xyzz on the stream of heads and tails."""
    from .scan import _segmented_reduce_xyzz

    buckets = bucket_array(curve, n_buckets, keys.device)
    pt, key = _run_level(curve, pts, signs, keys, buckets, n_buckets)
    return _segmented_reduce_xyzz(curve, pt, key, buckets, n_buckets)

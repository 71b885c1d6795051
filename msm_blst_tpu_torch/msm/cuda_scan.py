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

K5 replaces pallas_scan.py _seg_kernel (via _run_level and
segmented_reduce) and the levels after it (msm/scan.py
_segmented_reduce_xyzz and its two-element merge) in two parts:
`seg_level`, the affine level, one thread a lane down the c columns of the
key-sorted stream, complete runs stored straight into the bucket array in
place and each lane's head and tail handed on as the next stream; then
`seg_scan`, a segmented block scan of that stream on K4's tiles (a
head-flag scan; each run's last element stores its sum). The level's shape
is the port's own from MIN_LEVEL_N elements on (`seg_level_shape`: the
least level-and-scan depth within one wave), so the words of its heads and
tails differ from JAX's there and the bucket sums are the same points;
smaller streams keep the JAX package's pick_chunk columns and the level's
words. The TPU's lane slicing (_slice_lanes and its VMEM budgets) and its
opt-in (`available`) are not carried over: one launch takes all lanes.

The xyzz prefix scan (pallas_scan.py _scan_kernel and the chunk-tail carry
around it) is K4, the block scan of msm/scan.py `prefix_scan_xyzz`.

On a CUDA tensor every call goes through its kernel: the TPU launch-cost
thresholds (MIN_SCAN_N, prefix_available) gate nothing here. CPU tensors
take the plain versions.
"""

from __future__ import annotations

import torch

from ..curves.ops import AffinePoint, PackedRows32, XyzzPoint
from ..kernels import CURVE_KERNELS, check_cuda, on_cpu, ptr
from ..utils import scans
from . import scan

# K5's affine level takes the port's own shape (seg_level_shape) from this
# many elements on, the JAX package's pick_chunk columns below
MIN_LEVEL_N = 1024


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


def seg_level_shape(N: int):
    """(columns c, lanes n_ch) of K5's affine level over a stream of N
    elements: lane k takes elements k*c .. k*c + c-1. From MIN_LEVEL_N
    elements on, the c of least modelled depth c +
    scan_depth(scan_schedule(2 n_ch)), n_ch = ceil(N / c) (the level's c
    serial mixed adds down a lane, then the segmented scan's over the
    2 n_ch heads and tails, on K4's tiles), with n_ch within one wave of
    the level's blocks (scan.FOLD_WAVE blocks of scan.FOLD_THREADS lanes),
    at least two columns and c the fewest columns that n_ch lanes need;
    the fewer lanes on a tie. Smaller streams take the JAX package's
    pick_chunk columns (its unfused level), so that their words match it."""
    if N < MIN_LEVEL_N:
        c = scans.pick_chunk(N)
        return c, -(-N // c)
    best = None  # (depth, n_ch, c)
    c = max(2, -(-N // (scan.FOLD_WAVE * scan.FOLD_THREADS)))
    # the scan is at least one add deep, so no c from best's depth on wins
    while best is None or c < best[0]:
        n_ch = -(-N // c)
        cols = -(-N // n_ch)
        cand = (cols + scan.scan_depth(scan.scan_schedule(2 * n_ch)), n_ch,
                cols)
        best = cand if best is None else min(best, cand)
        c += 1
    return best[2], best[1]


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


def level_cols(curve, pts, signs, keys, n_buckets: int):
    """seg_level's inputs over a key-sorted signed affine stream of N
    elements, `pts` an AffinePoint (*F.lead, N) or its PackedRows32 rows
    (N, 2W), at seg_level_shape(N): lane k takes elements k*c .. k*c + c-1;
    pads are infinity with key n_buckets. Returns ((rows_x, rows_y), each
    (c, n_ch, W) words, signs cols (c, n_ch), keys cols (c, n_ch))."""
    W = curve.F.n_words
    N = keys.shape[0]
    c, n_ch = seg_level_shape(N)
    pad = n_ch * c - N

    def to_cols(x):  # (N,) -> (c, n_ch); column j holds elements k*c + j
        return x.reshape(n_ch, c).T.contiguous()

    kcols = to_cols(torch.cat([keys.to(torch.int32),
                               keys.new_full((pad,), n_buckets, dtype=torch.int32)]))
    rows = pts.XY if isinstance(pts, PackedRows32) else curve.to_rows32(pts).XY
    rows = torch.cat([rows, rows.new_zeros((pad, 2 * W))])
    g = rows.reshape(n_ch, c, 2 * W).transpose(0, 1)
    cols = (g[..., :W].contiguous(), g[..., W:].contiguous())
    scols = to_cols(scans.pad_last(signs.to(torch.int32), pad))
    return cols, scols, kcols


def seg_level_plain(curve, cols, signs, keys, buckets: XyzzPoint,
                    n_buckets: int):
    """Plain K5 affine level, the kernel's contract: `cols` (rows_x, rows_y)
    of (c, n_ch, W) words, `signs` and `keys` (c, n_ch). Complete runs are
    stored into `buckets` in place. Returns the next stream, lane k's head
    at 2k and tail at 2k + 1: an XyzzPoint (*F.lead, 2 n_ch) and its keys
    (2 n_ch,)."""
    F = curve.F.plain
    c, n_ch = keys.shape
    X, Y = (_lanes_last(curve, r) for r in cols)
    sub = signs != 0

    def lift(j):
        return curve.xyzz_from_affine(AffinePoint(X[j], Y[j]), negate=sub[j])

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
        added = curve.xyzz_dadd_affine_body(run, AffinePoint(X[j], Y[j]),
                                            subtract=sub[j], F=F)
        run = curve.select(closing, lift(j), added)
        from0 = from0 & ~closing
        run_key = ky
    out = XyzzPoint(*(torch.stack([h, t], dim=-1).reshape(curve.F.lead + (-1,))
                      for h, t in zip(head, run)))
    head_key = torch.where(from0, run_key, head_key)
    return out, torch.stack([head_key, run_key], dim=-1).reshape(-1)


def seg_level(curve, cols, signs, keys, buckets: XyzzPoint, n_buckets: int):
    """K5's affine level (see seg_level_plain for the contract): its kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if on_cpu(keys):
        return seg_level_plain(curve, cols, signs, keys, buckets, n_buckets)
    lead, W = curve.F.lead, curve.F.n_words
    c, n_ch = keys.shape
    dev = keys.device
    keys = keys.to(torch.int32).contiguous()
    rx, ry = (r.contiguous() for r in cols)
    sg = signs.to(torch.int32).contiguous()
    bk = list(buckets)
    if any(tuple(b.shape) != lead + (n_buckets,) for b in bk):
        raise ValueError(f"seg_level: buckets must be {lead + (n_buckets,)}")
    if rx.shape != (c, n_ch, W) or ry.shape != rx.shape or sg.shape != keys.shape:
        raise ValueError("seg_level: rows must be (c, n_ch, W) with signs "
                         "and keys (c, n_ch)")
    check_cuda("seg_level_affine", [rx, ry, sg, keys] + bk)
    out = _empty(curve, 2 * n_ch, dev)
    out_key = torch.empty(2 * n_ch, dtype=torch.int32, device=dev)
    CURVE_KERNELS[curve.name]["seg_level_affine"](
        ptr(rx), ptr(ry), ptr(sg), ptr(keys), *map(ptr, bk), n_buckets,
        *map(ptr, out), ptr(out_key), c, n_ch)
    return XyzzPoint(*out), out_key


def _seg_add(curve, a: XyzzPoint, b: XyzzPoint, fb) -> XyzzPoint:
    """The head-flag operator's point: b where `fb` (b starts a run), else
    a + b, the earlier sum first, as the kernel's add (the formula runs only
    where both are finite; a is masked to infinity where fb)."""
    a = XyzzPoint(*(c.masked_fill(fb, 0) for c in a))
    return scan._dadd_lanes(curve, a, b)


def _seg_block_scan(curve, acc: XyzzPoint, f):
    """The kernel's segmented Kogge-Stone along the last axis (the
    threads): at d = 1, 2, .., T/2 thread j >= d whose flag is clear adds
    thread j - d's sum in front of its own and takes its flag."""
    d = 1
    while d < acc.X.shape[-1]:
        added = _seg_add(curve, XyzzPoint(*(c[..., :-d] for c in acc)),
                         XyzzPoint(*(c[..., d:] for c in acc)), f[..., d:])
        acc = XyzzPoint(*(torch.cat([c[..., :d], a], dim=-1)
                          for c, a in zip(acc, added)))
        f = torch.cat([f[..., :d], f[..., d:] | f[..., :-d]], dim=-1)
        d *= 2
    return acc, f


def _seg_scan_values(curve, pts: XyzzPoint, flags, k: int, n_tiles: int,
                     k_carry: int) -> XyzzPoint:
    """The inclusive values of the segmented scan of (flags, pts) (*F.lead,
    N) on the kernel's tiles, batched over every tile and thread, with the
    kernel's operands in its order: thread sums and the block scan (up);
    for one tile each thread's values from thread j - 1's pair; for more,
    the one-tile scan of the tile totals with their flags and k_carry
    (carry), then each thread's values from thread j - 1's pair put after
    carry[t - 1] (down)."""
    N, T = flags.shape[0], scan.FOLD_THREADS
    elems = scan._thread_elems(pts, k, n_tiles)
    span = n_tiles * T * k
    pos = torch.arange(span, device=flags.device).reshape(n_tiles, T, k)
    fl = torch.cat([flags, flags.new_zeros(span - N)]).reshape(n_tiles, T, k)
    valid = pos < N
    acc, f = elems[0], fl[..., 0]
    for e in range(1, k):
        acc = curve.select(valid[..., e],
                           _seg_add(curve, acc, elems[e], fl[..., e]), acc)
        f = f | fl[..., e]
    incl, f = _seg_block_scan(curve, acc, f)
    prev = scan._shifted(incl)
    if n_tiles == 1:
        off = prev
    else:
        carry = _seg_scan_values(curve, XyzzPoint(*(c[..., -1] for c in incl)),
                                 f[..., -1], k_carry, 1, 0)
        before = XyzzPoint(*(c.unsqueeze(-1).expand(incl.X.shape)
                             for c in scan._shifted(carry)))
        pf = torch.cat([f.new_zeros(n_tiles, 1), f[..., :-1]], dim=-1)
        off = _seg_add(curve, before, prev, pf)
    outs = []
    for e in range(k):
        off = curve.select(valid[..., e],
                           _seg_add(curve, off, elems[e], fl[..., e]), off)
        outs.append(off)
    return XyzzPoint(*(torch.stack(cs, dim=-1).reshape(cs[0].shape[:-2] + (-1,))
                       [..., :N] for cs in zip(*outs)))


def _run_flags(keys):
    """(starts, ends): element e starts a run (e == 0 or its key differs
    from e - 1's), element e ends one (the last, or e + 1's key differs)."""
    change = keys[1:] != keys[:-1]
    one = change.new_ones(1)
    return torch.cat([one, change]), torch.cat([change, one])


def seg_scan_plain(curve, pts: XyzzPoint, keys, buckets: XyzzPoint,
                   n_buckets: int) -> None:
    """Plain K5 segmented scan, batched over every tile and thread with the
    kernel's schedule (scan.scan_schedule) and the operands of every add in
    its order: the head-flag scan of the key-sorted stream `pts`
    (*F.lead, M) with `keys` (M,), each run's sum stored into `buckets` at
    its key (keys outside [0, n_buckets) dropped). On the card it equals
    the kernel word for word."""
    M = keys.shape[0]
    if M == 0:
        return
    starts, ends = _run_flags(keys)
    vals = _seg_scan_values(curve, pts, starts, *scan.scan_schedule(M))
    store_points(buckets, torch.where(ends, keys, n_buckets), vals, n_buckets)


def seg_scan(curve, pts: XyzzPoint, keys, buckets: XyzzPoint,
             n_buckets: int) -> None:
    """The segmented scan that finishes the reduction (see seg_scan_plain):
    for CUDA tensors K5's scan kernel, one C call (one launch for one tile,
    up, carry and down for more); for CPU tensors seg_scan_plain."""
    if on_cpu(keys):
        return seg_scan_plain(curve, pts, keys, buckets, n_buckets)
    kernel = CURVE_KERNELS[curve.name]["seg_scan"]
    lead, W, T = curve.F.lead, curve.F.n_words, scan.FOLD_THREADS
    M = keys.shape[0]
    src = [c.contiguous() for c in pts]
    keys = keys.to(torch.int32).contiguous()
    bk = list(buckets)
    if any(tuple(c.shape) != lead + (M,) for c in src) or any(
            tuple(b.shape) != lead + (n_buckets,) for b in bk):
        raise ValueError(f"{kernel.symbol}: expected a stream of "
                         f"{lead + (M,)} and buckets of {lead + (n_buckets,)}")
    check_cuda(kernel.symbol, src + [keys] + bk)
    if M == 0:
        return
    k, n_tiles, k_carry = scan.scan_schedule(M)
    scratch = None if n_tiles == 1 else torch.empty(
        4 * W * n_tiles * (T + 2) + n_tiles * (T + 1), dtype=torch.int32,
        device=keys.device)
    kernel(*map(ptr, src), ptr(keys), *map(ptr, bk), n_buckets,
           None if scratch is None else ptr(scratch), M, n_tiles, k, k_carry)


def segmented_reduce(curve, pts, signs, keys, n_buckets: int) -> XyzzPoint:
    """Per-key sums of a key-sorted signed affine stream (see level_cols for
    `pts`) as an xyzz bucket array of n_buckets: K5's affine level at
    seg_level_shape, then its segmented scan over the level's heads and
    tails."""
    buckets = bucket_array(curve, n_buckets, keys.device)
    out, out_key = seg_level(curve, *level_cols(curve, pts, signs, keys,
                                                n_buckets), buckets, n_buckets)
    seg_scan(curve, out, out_key, buckets, n_buckets)
    return buckets

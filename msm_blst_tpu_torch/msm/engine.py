"""The port's MSM algorithms over G1 and G2 (port of
msm_blst_tpu/msm/engine.py: 62-145, 148-189, 197-230, 278-300, 327-368,
643-750). Each takes its curve from the plan (`plan.curve`).

* CHES "nh + 0.21q": `msm_ches_device` (on-device recode) and
  `msm_ches_host_recode` (host recode, the digit stream moved once to the
  plan's device); zero doublings, d-gap integration. On a plan with
  `noindexhash=True`, `msm_ches_device` keys the buckets by their value
  (JAX engine.py:338-354, reference multi_scalar.c:466-503): q/2 + 2 buckets,
  gathered back to the bucket set's order before the integration.
* BGMW95 q/2: `msm_bgmw_device`, with the r - a fold for tight configs and
  the consecutive-weight integration.
* Stock Pippenger (blst's, no precomputation): `msm_stock_pippenger`, one
  bucket pass per window from the top window down, c doublings between.

Each sorts its digit stream by bucket key and accumulates the buckets with
one of two strategies, chosen per call by the `bucket_impl` keyword:
"prefix" (prefix_pipeline, the default) or "segmented"
(scan.segmented_reduce_affine, K5).

* Big n: `msm_bign` (port of engine.py:476-640, `jit_msm_bign`): CHES or
  BGMW95 with the bucket accumulation split into bucket-range chunks
  (prefix_pipeline.bucket_sums_prefix_ranged), each chunk the exact slice
  of the sorted stream its buckets own, read after one host copy of the
  chunk starts.

A plan's rows come in the reference's order ("i" layout) or window-major
("j" layout, the streamed builders of precompute.py); `ches_slots` and
`bgmw_slots` read the plan's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..curves import cuda_point
from ..curves.ops import (AffinePoint, CurveOps, JacPoint, PackedRows32,
                          XyzzPoint)
from . import params as P
from . import recode
from .prefix_pipeline import (bucket_ranges, bucket_sums_prefix,
                              bucket_sums_prefix_ranged, chunks_for,
                              segment_starts)
from .scan import (fold_segments, fold_xyzz, scan_fold_axis,
                   segmented_reduce_affine, suffix_scan_xyzz)

BUCKET_IMPLS = ("prefix", "segmented")


def _sort_stream(slots, keys, signs):
    """(keys, slots, signs) sorted by key. The (slot, sign) payload rides a
    stable sort on the keys, so the order inside a bucket is the stream
    order (JAX's unstable sort leaves it arbitrary; bucket sums agree as
    points, not as xyzz words). Slots fit 30 bits (3nh < 2^27 at n =
    2^21)."""
    payload = (slots.to(torch.int32) << 1) | signs.to(torch.int32)
    keys_s, perm = torch.sort(keys.to(torch.int32), stable=True)
    payload_s = payload[perm]
    return keys_s, payload_s >> 1, (payload_s & 1) != 0


def _bucket_sums_stream(curve, table, slots, keys, signs, n_buckets: int,
                        impl: str):
    """Sort the digit stream by bucket key, then accumulate into buckets.

    slots/keys/signs: int/int/bool flat [N] streams (_sort_stream).
    `impl`: 'prefix' (prefix scan + boundary differences) or 'segmented'
    (head/tail/emission reduction)."""
    if impl not in BUCKET_IMPLS:
        raise ValueError(f"bucket_impl must be one of {BUCKET_IMPLS}, got {impl!r}")
    keys_s, slots_s, signs_s = _sort_stream(slots, keys, signs)
    if impl == "prefix":
        return bucket_sums_prefix(curve, table, slots_s, signs_s, keys_s,
                                  n_buckets)
    rows = PackedRows32(table.XY.index_select(0, slots_s.to(torch.int64)))
    return segmented_reduce_affine(curve, rows, signs_s, keys_s, n_buckets)


def _weighted_small(curve: CurveOps, pts: XyzzPoint) -> XyzzPoint:
    """Sum i * pts[i] over a small batch (suffix scan + fold)."""
    tail = XyzzPoint(*(c[..., 1:] for c in pts))
    return fold_xyzz(curve, suffix_scan_xyzz(curve, tail))


def integrate_weighted_consecutive(curve: CurveOps,
                                   buckets: XyzzPoint) -> XyzzPoint:
    """Sum i * buckets[i] over i = 0..K-1 (bucket 0's weight is 0).

    Index split i = u*C + v: Sum_i i*b_i = C * Sum_u u*R_u + Sum_v v*K_v
    with R_u the row sums and K_v the column sums of the (U, C) bucket grid
    (zero pad = infinity): two folds over K lanes plus two small weighted
    sums, instead of a full-width suffix scan (reference
    multi_scalar.c:281-297)."""
    K = buckets.X.shape[-1]
    if K <= 64:
        return _weighted_small(curve, buckets)
    C = 1 << max(K.bit_length() // 2, 1)
    U = -(-K // C)
    pad = U * C - K
    grid = XyzzPoint(*(torch.cat([c, c.new_zeros(c.shape[:-1] + (pad,))], dim=-1)
                       .reshape(c.shape[:-1] + (U, C)) for c in buckets))
    rows = scan_fold_axis(curve, grid, axis=-1)   # (U,)
    cols = scan_fold_axis(curve, grid, axis=-2)   # (C,)
    hi = _weighted_small(curve, rows)             # Sum_u u*R_u
    lo = _weighted_small(curve, cols)             # Sum_v v*K_v
    for _ in range(C.bit_length() - 1):
        hi = curve.xyzz_double(hi)
    return curve.xyzz_dadd(hi, lo)


class GapGroups(NamedTuple):
    """Host constants of integrate_gapped, on the device: the positions i
    of the suffix sums with gap_i == g, group after group for g = 1..d_max
    (`members`, int64), and group g's at [offsets[g-1], offsets[g])
    (`offsets`, host ints)."""

    members: torch.Tensor
    offsets: tuple


def gap_groups(gaps_np: np.ndarray, device=None) -> GapGroups:
    """integrate_gapped's constants for the bucket gaps `gaps_np`, moved
    once to `device`."""
    d_max = int(gaps_np.max()) if len(gaps_np) else 1
    members = [np.nonzero(gaps_np == g)[0] for g in range(1, d_max + 1)]
    offsets = tuple(int(o) for o in np.cumsum([0] + [len(m) for m in members]))
    return GapGroups(
        torch.as_tensor(np.concatenate(members).astype(np.int64), device=device),
        offsets)


def integrate_gapped(curve: CurveOps, buckets: XyzzPoint,
                     groups: GapGroups) -> XyzzPoint:
    """Sum bucket_value[i] * buckets[i] for a non-consecutive ascending
    bucket set with gaps <= d_max (reference multi_scalar.c:301-321, the
    d-CHES trick): Sum_i B[i]*bucket[i] = Sum_{i>=1} gap_{i-1} * S_i with
    S_i the suffix sums over buckets[1:]. `groups` = gap_groups(gaps): one
    fold of all d_max gap groups (K9), combined by Horner over the gap
    bits in one K2 launch (cuda_point.gap_horner)."""
    tail = XyzzPoint(*(c[..., 1:] for c in buckets))
    suffix = suffix_scan_xyzz(curve, tail)
    folded = fold_segments(curve, suffix, groups.offsets, index=groups.members)
    o = groups.offsets
    present = [o[g + 1] > o[g] for g in range(len(o) - 1)]
    return cuda_point.gap_horner(curve, folded, present)


@dataclass
class MsmPlan:
    """Device-resident tables + static config for one (curve, n, config)."""

    curve: CurveOps
    cfg: P.MsmConfig
    # CHES: slot 3*(i*h+j)+m-1 (reference main_p1.cpp:155-177), PackedRows32
    table3nh: Optional[PackedRows32] = None
    packed_table: Optional[torch.Tensor] = None  # int32[q+1, 2] pairs layout
    # int32[q+1], bucket values in place of indexes (the noindexhash keys)
    packed_table_value: Optional[torch.Tensor] = None
    bucket_gaps: Optional[np.ndarray] = None     # host int32[B_SIZE-1]
    gap_groups: Optional[GapGroups] = None       # gap_groups(bucket_gaps)
    noindexhash: bool = False
    # BGMW95: slot i*h'+j (reference main_p1.cpp:94-122), PackedRows32
    table_nh: Optional[PackedRows32] = None
    # the nh table aliased into table3nh's m=1 rows (slot 3*(i*h+j)) when the
    # CHES and BGMW radixes match (reference main_p1.cpp:99-106)
    bgmw_stride3: bool = False
    # stock: the raw fixed points and their rows
    points: Optional[AffinePoint] = None
    points_rows: Optional[PackedRows32] = None
    # table row order: "i" the reference's (above), "j" window-major (the
    # streamed builders): CHES 3*(j*n+i)+m-1, BGMW j*n+i
    layout: str = "i"


def ches_slots(i_idx, j_idx, m1, h: int, n: int = 0, layout: str = "i"):
    """Table row of the (i, j, m) CHES precompute entry: 3*(i*h+j)+m-1 in
    the reference's "i" layout, 3*(j*n+i)+m-1 in the window-major "j"
    layout of n points."""
    if layout == "j":
        return 3 * (j_idx * n + i_idx) + m1
    return 3 * (i_idx * h + j_idx) + m1


def bgmw_slots(i_idx, j_idx, h: int, n: int = 0, layout: str = "i"):
    """Table row of the (i, j) BGMW95 entry: i*h+j ("i"), j*n+i ("j")."""
    if layout == "j":
        return j_idx * n + i_idx
    return i_idx * h + j_idx


def bgmw_table(plan: MsmPlan):
    """(the BGMW table, its rows a slot): the dedicated nh table (1), or the
    stride-3 view of the 3nh CHES table when the radixes match (3): its m=1
    rows, at 3*slot in both layouts (3*(i*h+j) and 3*(j*n+i))."""
    if plan.table_nh is not None:
        return plan.table_nh, 1
    if plan.bgmw_stride3 and plan.table3nh is not None:
        return plan.table3nh, 3
    raise ValueError("plan has no BGMW table (build_plan(..., bgmw=True))")


def bgmw_table_slots(plan: MsmPlan, slots):
    """The BGMW table and the rows of `slots` in it (bgmw_table)."""
    table, stride = bgmw_table(plan)
    return table, slots if stride == 1 else slots * stride


def _ches_query(plan: MsmPlan, slots, keys, signs, impl) -> JacPoint:
    buckets = _bucket_sums_stream(plan.curve, plan.table3nh, slots, keys,
                                  signs, plan.cfg.b_size, impl)
    return plan.curve.xyzz_to_jac(
        integrate_gapped(plan.curve, buckets, plan.gap_groups))


def _ches_streams(plan: MsmPlan, scalars: torch.Tensor,
                  value_keyed: bool = False):
    """The CHES digit stream of the device recode, flat [n*h]: (slots in
    the plan's layout, bucket keys, signs). The keys are bucket indexes,
    or with `value_keyed` bucket values (plan.packed_table_value)."""
    table = plan.packed_table_value if value_keyed else plan.packed_table
    if table is None:
        raise ValueError("the port's CHES query needs the packed digit "
                         "tables (build_plan attaches them)")
    cfg = plan.cfg
    n = scalars.shape[1]
    h = cfg.h
    dev = scalars.device
    i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    j_idx = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    keys, m1, s = recode.ches_recode_device_packed(scalars, cfg.c, h, table)
    slots = ches_slots(i_idx, j_idx, m1, h, n, plan.layout)
    return slots.reshape(-1), keys.reshape(-1), s.reshape(-1)


def _bgmw_streams(plan: MsmPlan, scalars: torch.Tensor):
    """The BGMW95 digit stream, flat [n*h']: (the table it reads, slots in
    that table, |digit| keys, signs), the digits of
    recode.bgmw_digits_device (mod r, then the r - a fold for tight
    configs)."""
    cfg = plan.cfg
    h = cfg.h_bgmw
    n = scalars.shape[1]
    dev = scalars.device
    absd, sign = recode.bgmw_digits_device(scalars, cfg.c_bgmw, h)  # [h, n]
    i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    j_idx = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    table, slots = bgmw_table_slots(
        plan, bgmw_slots(i_idx, j_idx, h, n, plan.layout))
    return table, slots.reshape(-1), absd.reshape(-1), sign.reshape(-1)


@functools.lru_cache(maxsize=4)
def _bucket_set_on(cfg: P.MsmConfig, device: torch.device) -> torch.Tensor:
    """The CHES bucket values in ascending order, int64 on `device`, copied
    there once for the last few (config, device) pairs."""
    return torch.as_tensor(cfg.bucket_set().astype(np.int64), device=device)


def msm_ches_device(plan: MsmPlan, scalars: torch.Tensor,
                    bucket_impl: str = "prefix") -> JacPoint:
    """CHES 'nh + 0.21q' MSM with on-device integral scalar conversion.

    scalars: int32[8, n] (recode.to_device) on the plan's device. Returns a
    Jacobian batch of 1. Query path: zero doublings (reference
    main_p1.cpp:192-246 + multi_scalar.c:421-463). With plan.noindexhash
    the buckets are keyed by value, q/2 + 2 of them, and the occupied ones
    are gathered back to the bucket set's order (multi_scalar.c:466-503)."""
    if not plan.noindexhash:
        return _ches_query(plan, *_ches_streams(plan, scalars), bucket_impl)
    curve, cfg = plan.curve, plan.cfg
    slots, keys, signs = _ches_streams(plan, scalars, value_keyed=True)
    buckets_val = _bucket_sums_stream(curve, plan.table3nh, slots, keys, signs,
                                      (cfg.q >> 1) + 2, bucket_impl)
    buckets = curve.take(buckets_val, _bucket_set_on(cfg, scalars.device))
    return curve.xyzz_to_jac(integrate_gapped(curve, buckets, plan.gap_groups))


def msm_ches_host_recode(plan: MsmPlan, scalars_np: np.ndarray,
                         bucket_impl: str = "prefix") -> JacPoint:
    """CHES MSM with the recode on the host (the reference's method 1): the
    digit stream is computed with numpy and moved once to the plan's
    device, then sorted, accumulated and integrated there."""
    cfg = plan.cfg
    n = scalars_np.shape[1]
    h = cfg.h
    b, m, s = recode.ches_recode_host(scalars_np, cfg.c, h, cfg.ah)  # [n, h]
    keys = P.bucket_value_to_index(cfg.q, cfg.ah)[b]
    i_idx = np.arange(n, dtype=np.int64)[:, None]
    j_idx = np.arange(h, dtype=np.int64)[None, :]
    slots = ches_slots(i_idx, j_idx, m - 1, h, n, plan.layout).astype(np.int32)
    dev = plan.table3nh.XY.device
    return _ches_query(plan,
                       torch.as_tensor(slots.reshape(-1), device=dev),
                       torch.as_tensor(keys.reshape(-1), device=dev),
                       torch.as_tensor(s.reshape(-1), device=dev), bucket_impl)


def msm_bgmw_device(plan: MsmPlan, scalars: torch.Tensor,
                    bucket_impl: str = "prefix") -> JacPoint:
    """BGMW95 q/2 variant, fully on the device (reference main_p1.cpp:
    294-398), with the consecutive-weight integration."""
    curve = plan.curve
    table, slots, keys, signs = _bgmw_streams(plan, scalars)
    buckets = _bucket_sums_stream(curve, table, slots, keys, signs,
                                  (plan.cfg.q_bgmw >> 1) + 1, bucket_impl)
    return curve.xyzz_to_jac(integrate_weighted_consecutive(curve, buckets))


def _mul_small_xyzz(curve: CurveOps, pt: XyzzPoint, k: int) -> XyzzPoint:
    """pt * k for a small positive int k (double-and-add on one point)."""
    acc = pt
    for bit in bin(k)[3:]:
        acc = curve.xyzz_double(acc)
        if bit == "1":
            acc = curve.xyzz_dadd(acc, pt)
    return acc


def _bgmw_partials_ranged(curve: CurveOps, table, slots_s, signs_s, keys_s,
                          starts, W: int):
    """BGMW's bucket-range chunks with the consecutive-weight integration
    fused into each: chunk k (buckets [kW, (k+1)W)) emits S_k = fold(b) and
    T_k = sum_v v*b_v only, so no bucket array wider than W exists. Returns
    (S, T), xyzz batches of K = len(starts) - 1."""
    S, T = [], []
    for b in bucket_ranges(curve, table, slots_s, signs_s, keys_s, starts, W):
        T.append(integrate_weighted_consecutive(curve, b))
        S.append(fold_xyzz(curve, b))

    def stack(parts):
        return XyzzPoint(*(torch.cat(cs, dim=-1) for cs in zip(*parts)))

    return stack(S), stack(T)


def msm_bign(plan: MsmPlan, scalars: torch.Tensor, algo: str = "ches",
             n_chunks: Optional[int] = None) -> JacPoint:
    """Big-n CHES (`algo="ches"`) or BGMW95 (`"bgmw"`) MSM with the bucket
    accumulation split into `n_chunks` bucket ranges (port of JAX's
    jit_msm_bign, one plain function): the digit stream, one stable sort,
    one host read of the K+1 chunk starts in the sorted stream, then a host
    loop over the chunks, each on its exact slice of the stream.

    CHES concatenates the chunks' buckets and integrates them once
    (integrate_gapped). BGMW integrates inside each chunk: chunk k emits
    S_k and T_k, and the total is W * sum_k k*S_k + sum_k T_k. n_chunks
    None: one chunk for CPU tensors; on the card, as many as the free
    device memory needs (prefix_pipeline.chunks_for)."""
    curve, cfg = plan.curve, plan.cfg
    if algo == "ches":
        table = plan.table3nh
        slots, keys, signs = _ches_streams(plan, scalars)
        n_buckets = cfg.b_size
    elif algo == "bgmw":
        table, slots, keys, signs = _bgmw_streams(plan, scalars)
        n_buckets = (cfg.q_bgmw >> 1) + 1
    else:
        raise ValueError(f"msm_bign: algo must be 'ches' or 'bgmw', got "
                         f"{algo!r}")
    keys_s, slots_s, signs_s = _sort_stream(slots, keys, signs)
    del slots, keys, signs
    K = n_chunks or chunks_for(curve, keys_s)
    starts, W = segment_starts(keys_s, n_buckets, K)
    starts = starts.tolist()  # the one host read of the query
    if algo == "ches":
        buckets = bucket_sums_prefix_ranged(curve, table, slots_s, signs_s,
                                            keys_s, n_buckets, starts)
        return curve.xyzz_to_jac(
            integrate_gapped(curve, buckets, plan.gap_groups))
    S, T = _bgmw_partials_ranged(curve, table, slots_s, signs_s, keys_s,
                                 starts, W)
    total = fold_xyzz(curve, T)
    if K > 1:
        hi = _mul_small_xyzz(curve, integrate_weighted_consecutive(curve, S),
                             W)
        total = curve.xyzz_dadd(hi, total)
    return curve.xyzz_to_jac(total)


def msm_stock_pippenger(plan: MsmPlan, scalars: torch.Tensor,
                        window: Optional[int] = None, nbits: int = 255,
                        bucket_impl: str = "prefix") -> JacPoint:
    """Stock Pippenger, no precomputation (reference multi_scalar.c:
    549-576): per window a bucket pass over the n points and a weighted
    integration, combined from the top window down with c doublings.

    nbits bounds the scalars (blst API parity); one extra bit of headroom
    keeps the top signed digit <= q/2."""
    curve = plan.curve
    if plan.points_rows is None:
        raise ValueError("plan has no point rows (build_plan(..., stock=True))")
    n = scalars.shape[1]
    c = window or pippenger_window_size(n)
    h = -(-(nbits + 1) // c)
    absd, sign = recode.signed_digits_device(scalars, c, h)  # [h, n]
    n_buckets = (1 << (c - 1)) + 1
    point_idx = torch.arange(n, dtype=torch.int32, device=scalars.device)
    acc = curve.xyzz_inf((1,), scalars.device)
    for j in range(h - 1, -1, -1):
        buckets = _bucket_sums_stream(curve, plan.points_rows, point_idx,
                                      absd[j], sign[j], n_buckets, bucket_impl)
        tile = integrate_weighted_consecutive(curve, buckets)
        for _ in range(c):
            acc = curve.xyzz_double(acc)
        acc = curve.xyzz_dadd(acc, tile)
    return curve.xyzz_to_jac(acc)


def pippenger_window_size(npoints: int) -> int:
    """blst's window heuristic (reference auxiliaryfunc.h:316-323)."""
    wbits = max(npoints.bit_length() - 1, 0)
    if wbits > 12:
        return wbits - 3
    if wbits > 4:
        return wbits - 2
    return 2 if wbits else 1

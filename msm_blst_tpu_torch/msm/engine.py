"""The CHES "nh + 0.21q" MSM query (port of msm_blst_tpu/msm/engine.py:82-99,
148-189, 197-230, 278-282, 327-368).

Query path, zero doublings: on-device recode -> sort of the digit stream
by bucket -> prefix-scan bucket accumulation (prefix_pipeline) -> d-gap
integration -> Jacobian result. BGMW95, stock Pippenger, the noindexhash
variant and the big-n ranged driver are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..curves.ops import CurveOps, JacPoint, PackedRows32, XyzzPoint
from . import params as P
from . import recode
from .prefix_pipeline import bucket_sums_prefix
from .scan import fold_xyzz, suffix_scan_xyzz


def _bucket_sums_stream(curve, table, slots, keys, signs, n_buckets: int):
    """Sort the digit stream by bucket key, then accumulate into buckets.

    slots/keys/signs: int/int/bool flat [N] streams. The (slot, sign)
    payload rides a stable sort on the keys, so the order inside a bucket
    is the stream order (JAX's unstable sort leaves it arbitrary; bucket
    sums agree as points, not as xyzz words)."""
    payload = (slots.to(torch.int32) << 1) | signs.to(torch.int32)
    keys_s, perm = torch.sort(keys.to(torch.int32), stable=True)
    payload_s = payload[perm]
    signs_s = (payload_s & 1) != 0
    slots_s = payload_s >> 1
    return bucket_sums_prefix(curve, table, slots_s, signs_s, keys_s,
                              n_buckets)


def gap_groups(gaps_np: np.ndarray, device=None) -> tuple:
    """Host constants of integrate_gapped, moved once to the device: for
    g = 1..d_max the suffix positions i with gap_i == g (None if empty)."""
    d_max = int(gaps_np.max()) if len(gaps_np) else 1
    groups = []
    for g in range(1, d_max + 1):
        members = np.nonzero(gaps_np == g)[0]
        groups.append(torch.as_tensor(members.astype(np.int64), device=device)
                      if len(members) else None)
    return tuple(groups)


def integrate_gapped(curve: CurveOps, buckets: XyzzPoint, groups) -> XyzzPoint:
    """Sum bucket_value[i] * buckets[i] for a non-consecutive ascending
    bucket set with gaps <= d_max (reference multi_scalar.c:301-321, the
    d-CHES trick): Sum_i B[i]*bucket[i] = Sum_{i>=1} gap_{i-1} * S_i with
    S_i the suffix sums over buckets[1:]. `groups` = gap_groups(gaps): one
    exact-size fold per gap value, combined by Horner over the gap bits."""
    tail = XyzzPoint(*(c[..., 1:] for c in buckets))
    suffix = suffix_scan_xyzz(curve, tail)
    sums = [None if members is None else fold_xyzz(curve, curve.take(suffix, members))
            for members in groups]
    acc: Optional[XyzzPoint] = None
    d_max = len(groups)
    for bit in range(d_max.bit_length() - 1, -1, -1):
        sel = [s for g, s in enumerate(sums, start=1)
               if ((g >> bit) & 1) and s is not None]
        part = None
        if sel:
            part = sel[0]
            for s in sel[1:]:
                part = curve.xyzz_dadd(part, s)
        if acc is not None:
            acc = curve.xyzz_double(acc)
            if part is not None:
                acc = curve.xyzz_dadd(acc, part)
        else:
            acc = part
    return acc


@dataclass
class MsmPlan:
    """Device-resident tables + static config for one (curve, n, config)."""

    curve: CurveOps
    cfg: P.MsmConfig
    # slot 3*(i*h+j)+m-1 (reference main_p1.cpp:155-177), PackedRows32 rows
    table3nh: Optional[PackedRows32] = None
    packed_table: Optional[torch.Tensor] = None  # int32[q+1, 2] pairs layout
    bucket_gaps: Optional[np.ndarray] = None     # host int32[B_SIZE-1]
    gap_groups: Optional[tuple] = None           # gap_groups(bucket_gaps)
    noindexhash: bool = False


def ches_slots(i_idx, j_idx, m1, h: int):
    """Table row of the (i, j, m) CHES precompute entry in the reference's
    row order (the JAX package's "i" layout; the window-major "j" layout of
    its streamed big-n builders is not ported)."""
    return 3 * (i_idx * h + j_idx) + m1


def msm_ches_device(plan: MsmPlan, scalars: torch.Tensor) -> JacPoint:
    """CHES 'nh + 0.21q' MSM with on-device integral scalar conversion.

    scalars: int32[8, n] (recode.to_device) on the plan's device. Returns a
    Jacobian batch of 1. Query path: zero doublings (reference
    main_p1.cpp:192-246 + multi_scalar.c:421-463)."""
    cfg, curve = plan.cfg, plan.curve
    if plan.noindexhash:
        raise NotImplementedError("the noindexhash variant is not ported yet")
    if plan.packed_table is None:
        raise NotImplementedError("the port's CHES query needs the packed "
                                  "digit table (build_plan attaches it)")
    n = scalars.shape[1]
    h = cfg.h
    dev = scalars.device
    i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    j_idx = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    keys, m1, s = recode.ches_recode_device_packed(
        scalars, cfg.c, h, plan.packed_table)
    slots = ches_slots(i_idx, j_idx, m1, h)
    buckets = _bucket_sums_stream(
        curve, plan.table3nh, slots.reshape(-1), keys.reshape(-1),
        s.reshape(-1), cfg.b_size)
    return curve.xyzz_to_jac(integrate_gapped(curve, buckets, plan.gap_groups))

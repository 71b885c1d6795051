"""Precomputation: fixed-point lists, the CHES 3nh and BGMW95 nh tables and
the plan (port of msm_blst_tpu/msm/precompute.py:39-168, 425-488).

* P_i = 2^(i+1)*G (reference main_p1.cpp:52-66) is evaluated as e_i*G with
  a fixed-base window table: depth 32, width n, one K2 mixed add per window.
* q^j*P_i with q = 2^c is a batched doubling chain: c*h doublings over all
  n points, plus one batched to-affine at the end.

Only the reference ("i") row order is ported; the streamed big-n builders
(the "j" layout) wait for a later slice.

`mul_impl` ("cios" or "sos") picks the kernel of every unfused field
product — the batched to-affine's inversions above all: the builders run on
the curve instance over that field (curves.for_mul_impl), and the plan
carries it, so the queries on the plan use it too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import refimpl as ref
from ..constants import R_ORDER
from ..device import resolve
from ..curves.curve import for_mul_impl
from ..curves.ops import AffinePoint, CurveOps, XyzzPoint
from . import params as P
from .engine import MsmPlan, gap_groups

_W = 8  # fixed-base window bits: a window digit is one byte of the scalar


@functools.lru_cache(maxsize=2)
def _fixed_base_table_host(curve_name: str):
    """T[j][d] = d * 2^(8j) * G as affine ints (pairs of ints for G1, of
    int pairs for G2), built once per curve with the oracle."""
    curve = ref.CURVES[curve_name]
    base = curve.GENERATOR
    table = []
    for _ in range(256 // _W):
        row = [curve.INF]
        for _d in range(1, 1 << _W):
            row.append(curve.add(row[-1], base))
        table.append(row)
        for _ in range(_W):
            base = curve.add(base, base)
    return table


def fixed_base_mult(curve: CurveOps, scalars_ints, device=None,
                    mul_impl: str = "cios") -> AffinePoint:
    """[e_0..e_{n-1}] ints -> affine batch of e_i * G (windowed fixed base),
    on `device` (default: the card), field products on `mul_impl`."""
    device = resolve(device)
    curve = for_mul_impl(mul_impl)[curve.name]
    host_table = _fixed_base_table_host(curve.name)
    windows = len(host_table)
    rows = [curve.affine_from_ints(row, device=device) for row in host_table]
    tx = torch.stack([r.X for r in rows])  # (windows, *F.lead, 2^w)
    ty = torch.stack([r.Y for r in rows])
    raw = b"".join((e % R_ORDER).to_bytes(32, "little") for e in scalars_ints)
    digits = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 32).T[:windows]
    digits = torch.as_tensor(digits.astype(np.int64), device=device)
    acc = curve.xyzz_inf((digits.shape[1],), device)
    for j in range(windows):
        pts = AffinePoint(tx[j].index_select(-1, digits[j]),
                          ty[j].index_select(-1, digits[j]))
        acc = curve.xyzz_dadd_affine(acc, pts)
    return curve.xyzz_to_affine(acc)


def fixed_point_list(curve: CurveOps, n: int, device=None,
                     mul_impl: str = "cios") -> AffinePoint:
    """P_i = 2^(i+1) * G, i = 0..n-1 — the reference's fixed points, on
    `device` (default: the card), field products on `mul_impl`."""
    es = [pow(2, i + 1, R_ORDER) for i in range(n)]
    return fixed_base_mult(curve, es, device=device, mul_impl=mul_impl)


def _doubling_chain_tables(curve: CurveOps, points: AffinePoint, c: int,
                           h: int, with_m23: bool) -> XyzzPoint:
    """For j in 0..h-1 emit (q^j P_i [, 2 q^j P_i, 3 q^j P_i]), advancing by
    c batched doublings per window. Coordinates shaped (h, n_m, *F.lead,
    n)."""
    cur = curve.xyzz_from_affine(points)
    slots = []
    for _ in range(h):
        group = [cur]
        if with_m23:
            d2 = curve.xyzz_double(cur)
            group += [d2, curve.xyzz_dadd(d2, cur)]
        slots.append(XyzzPoint(*(torch.stack(cs) for cs in zip(*group))))
        for _ in range(c):
            cur = curve.xyzz_double(cur)
    return XyzzPoint(*(torch.stack([s[i] for s in slots]) for i in range(4)))


def _slots_to_affine_table(curve: CurveOps, slots: XyzzPoint,
                           n: int) -> AffinePoint:
    """Flatten (h, n_m, *F.lead, n) slots into the reference's table order
    (slot = n_m*(i*h+j)+(m-1), reference main_p1.cpp:100,163) and convert to
    affine with one batched inversion per coordinate."""
    h, n_m = slots.X.shape[0], slots.X.shape[1]
    W = curve.F.n_words
    # (*F.lead, h*n_m*n) in (j, m, i) order
    flat = XyzzPoint(*(curve.from_words(
        x.reshape(h, n_m, W, n).permute(2, 0, 1, 3).reshape(W, h * n_m * n))
        for x in slots))
    aff = curve.xyzz_to_affine(flat)
    # dest slot s = n_m*(i*h+j)+(m-1) <- src = (j*n_m + m-1)*n + i
    i_ = np.arange(n)[:, None, None]
    j_ = np.arange(h)[None, :, None]
    m_ = np.arange(n_m)[None, None, :]
    src = ((j_ * n_m + m_) * n + i_).reshape(-1)
    return curve.take(aff, torch.as_tensor(src, device=slots.X.device))


def build_ches_table(curve: CurveOps, points: AffinePoint,
                     cfg: P.MsmConfig) -> AffinePoint:
    """PRECOMPUTATION_POINTS_LIST_3nh (reference main_p1.cpp:128-178)."""
    slots = _doubling_chain_tables(curve, points, cfg.c, cfg.h, with_m23=True)
    return _slots_to_affine_table(curve, slots, points.X.shape[-1])


def build_bgmw_table(curve: CurveOps, points: AffinePoint,
                     cfg: P.MsmConfig) -> AffinePoint:
    """PRECOMPUTATION_POINTS_LIST_BGMW95 (reference main_p1.cpp:94-122):
    slot i*h'+j holds q'^j P_i."""
    slots = _doubling_chain_tables(curve, points, cfg.c_bgmw, cfg.h_bgmw,
                                   with_m23=False)
    return _slots_to_affine_table(curve, slots, points.X.shape[-1])


def build_plan(curve: CurveOps, points: AffinePoint, cfg: P.MsmConfig,
               ches: bool = True, bgmw: bool = True, stock: bool = True,
               streamed: bool = False, device=None,
               mul_impl: str = "cios") -> MsmPlan:
    """The tables of the requested algorithms, as PackedRows32 rows in the
    "i" layout, on `device` (default: the points' device). The plan's curve
    is `curve` over the field whose products run on `mul_impl`.

    ches: the 3nh table with the digit table and gap constants. bgmw: the nh
    table, or none when CHES and BGMW share the radix and window count: the
    BGMW query then reads the 3nh table's m=1 rows (bgmw_stride3, the
    reference's reuse, main_p1.cpp:99-106). stock: the points' own rows.
    streamed=True (the JAX package's "j"-layout big-n builders) is not
    ported."""
    if streamed:
        raise NotImplementedError("the streamed big-n table builders are not "
                                  "ported yet")
    device = points.X.device if device is None else torch.device(device)
    curve = for_mul_impl(mul_impl)[curve.name]
    points = AffinePoint(*(x.to(device) for x in points))
    plan = MsmPlan(curve=curve, cfg=cfg, points=points)
    if ches and bgmw and cfg.c == cfg.c_bgmw and cfg.h == cfg.h_bgmw:
        bgmw = False
        plan.bgmw_stride3 = True
    if ches:
        plan.table3nh = curve.to_rows32(build_ches_table(curve, points, cfg))
        _attach_ches_params(plan, cfg, device)
    if bgmw:
        plan.table_nh = curve.to_rows32(build_bgmw_table(curve, points, cfg))
    if stock:
        plan.points_rows = curve.to_rows32(points)
    return plan


def _attach_ches_params(plan: MsmPlan, cfg: P.MsmConfig, device) -> None:
    """Config-derived digit table and bucket-gap constants (host-cheap)."""
    plan.packed_table = torch.as_tensor(
        P.packed_digit_table_pairs(cfg.q, cfg.ah), device=device)
    bs = cfg.bucket_set()
    plan.bucket_gaps = np.diff(bs).astype(np.int32)
    if plan.bucket_gaps.max() > cfg.d_max:
        raise ValueError(f"bucket gap {plan.bucket_gaps.max()} exceeds "
                         f"d_max={cfg.d_max}")
    plan.gap_groups = gap_groups(plan.bucket_gaps, device)

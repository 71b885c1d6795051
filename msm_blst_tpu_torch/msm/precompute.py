"""Precomputation: fixed-point lists, the CHES 3nh and BGMW95 nh tables and
the plan (port of msm_blst_tpu/msm/precompute.py:39-168, 198-488).

* P_i = 2^(i+1)*G (reference main_p1.cpp:52-66) is evaluated as e_i*G with
  a fixed-base window table: depth 32, width n, one K2 mixed add per window.
* q^j*P_i with q = 2^c is a batched doubling chain: c*h doublings over all
  n points, plus one batched to-affine at the end.

Two row orders: the reference's ("i" layout: all windows stacked in xyzz,
one to-affine, one permutation; `build_ches_table`, `build_bgmw_table`),
and the streamed builders' window-major "j" layout
(`build_ches_table_rows_streamed`, `build_bgmw_table_rows_streamed`),
which write each window of each part of the points into a preallocated
table as it is made, so the device holds the table and one window part's
transients. `build_plan` streams from n = 2^17 on, as the JAX package does.

`mul_impl` ("cios" or "sos") picks the kernel of every unfused field
product — the batched to-affine's inversions above all: the builders run on
the curve instance over that field (curves.for_mul_impl), and the plan
carries it, so the queries on the plan use it too.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .. import refimpl as ref
from ..constants import R_ORDER
from ..device import budget_bytes, resolve
from ..curves.curve import for_mul_impl
from ..curves.ops import AffinePoint, CurveOps, PackedRows32, XyzzPoint
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
    es, e = [], 1
    for _ in range(n):
        e = 2 * e % R_ORDER
        es.append(e)
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


def window_lane_bytes(curve: CurveOps, n_m: int) -> int:
    """Device bytes one point lane of a streamed builder's window step
    costs at its peak, E = 4 * F.n_words bytes a coordinate: the doubling
    chain's point and its next doubling (8 E), and for each of the n_m
    multiples formed (P; or P, 2P, 3P) its xyzz coordinates stacked for the
    conversion (4 E), the batch inversion's transients (about 14 copies of
    one coordinate: two chunked product scans, their carries and the
    combined products, utils/scans.py) and the affine coordinates and rows
    (6 E). Fp2 doubles the transients a word: its products stack their
    Karatsuba operands and its inversion goes through the norms (on an
    H100 a G1 lane of a CHES window took 3.6 KB, a G2 lane 16 KB)."""
    per_word = 2 if len(curve.F.lead) > 1 else 1
    return 4 * curve.F.n_words * (8 + 24 * n_m) * per_word


def _point_parts(curve: CurveOps, n: int, n_m: int, device,
                 parts: Optional[int]) -> int:
    """The number of point parts a streamed build splits n lanes into:
    `parts` if given; else one for CPU tensors, and on the card as many as
    the free device memory (device.budget_bytes, read after the table is
    allocated) needs."""
    if parts:
        return parts
    if device.type == "cpu":
        return 1
    fit = max(1, budget_bytes(device) // window_lane_bytes(curve, n_m))
    return -(-n // fit)


def _build_rows_streamed(curve: CurveOps, points: AffinePoint, c: int,
                         h: int, with_m23: bool,
                         parts: Optional[int]) -> PackedRows32:
    """The window-major table: for each part of n_p points and each window
    j, the part's (q^j P [, 2 q^j P, 3 q^j P]) converted to affine with one
    batch inversion and packed to rows at row (j*n + p*n_p) * n_m, then c
    K2 doublings to the next window (none after the last)."""
    n = points.X.shape[-1]
    device = points.X.device
    n_m = 3 if with_m23 else 1
    table = torch.empty((h * n_m * n, 2 * curve.F.n_words), dtype=torch.int32,
                        device=device)
    n_p = -(-n // _point_parts(curve, n, n_m, device, parts))
    for lo in range(0, n, n_p):
        part = AffinePoint(*(x[..., lo:lo + n_p] for x in points))
        width = part.X.shape[-1]
        cur = curve.xyzz_from_affine(part)
        for j in range(h):
            grp = cur
            if with_m23:
                d2 = curve.xyzz_double(cur)
                d3 = curve.xyzz_dadd(d2, cur)
                # lane 3i + m - 1 holds m q^j P_i
                grp = XyzzPoint(*(
                    torch.stack(cs, dim=-1).reshape(curve.F.lead + (3 * width,))
                    for cs in zip(cur, d2, d3)))
                del d2, d3
            start = (j * n + lo) * n_m
            table[start:start + n_m * width] = curve.to_rows32(
                curve.xyzz_to_affine(grp)).XY
            del grp
            if j + 1 < h:
                for _ in range(c):
                    cur = curve.xyzz_double(cur)
    return PackedRows32(table)


def build_ches_table_rows_streamed(curve: CurveOps, points: AffinePoint,
                                   cfg: P.MsmConfig,
                                   parts: Optional[int] = None
                                   ) -> PackedRows32:
    """The CHES 3nh table in the window-major "j" layout, row
    3*(j*n + i) + m - 1 (port of the JAX package's window-at-a-time
    build_ches_table_rows_bigmem, the same rows word for word). `parts`:
    the point parts a window is converted in (default: by the free device
    memory; one on the CPU)."""
    return _build_rows_streamed(curve, points, cfg.c, cfg.h, True, parts)


def build_bgmw_table_rows_streamed(curve: CurveOps, points: AffinePoint,
                                   cfg: P.MsmConfig,
                                   parts: Optional[int] = None
                                   ) -> PackedRows32:
    """The BGMW95 nh table in the "j" layout, row j*n + i holding q'^j P_i
    (port of build_bgmw_table_rows_bigmem)."""
    return _build_rows_streamed(curve, points, cfg.c_bgmw, cfg.h_bgmw, False,
                                parts)


def build_plan(curve: CurveOps, points: AffinePoint, cfg: P.MsmConfig,
               ches: bool = True, bgmw: bool = True, stock: bool = True,
               streamed: Optional[bool] = None, device=None,
               mul_impl: str = "cios") -> MsmPlan:
    """The tables of the requested algorithms as PackedRows32 rows, on
    `device` (default: the points' device). The plan's curve is `curve`
    over the field whose products run on `mul_impl`.

    ches: the 3nh table with the digit table and gap constants. bgmw: the nh
    table, or none when CHES and BGMW share the radix and window count: the
    BGMW query then reads the 3nh table's m=1 rows (bgmw_stride3, the
    reference's reuse, main_p1.cpp:99-106), in either layout. stock: the
    points' own rows. streamed: the window-major builders ("j" layout);
    None streams from n = 2^17 on."""
    device = points.X.device if device is None else torch.device(device)
    curve = for_mul_impl(mul_impl)[curve.name]
    points = AffinePoint(*(x.to(device) for x in points))
    if streamed is None:
        streamed = points.X.shape[-1] >= (1 << 17)
    plan = MsmPlan(curve=curve, cfg=cfg, points=points,
                   layout="j" if streamed else "i")
    if ches and bgmw and cfg.c == cfg.c_bgmw and cfg.h == cfg.h_bgmw:
        bgmw = False
        plan.bgmw_stride3 = True
    if ches:
        plan.table3nh = (
            build_ches_table_rows_streamed(curve, points, cfg) if streamed
            else curve.to_rows32(build_ches_table(curve, points, cfg)))
        _attach_ches_params(plan, cfg, device)
    if bgmw:
        plan.table_nh = (
            build_bgmw_table_rows_streamed(curve, points, cfg) if streamed
            else curve.to_rows32(build_bgmw_table(curve, points, cfg)))
    if stock:
        plan.points_rows = curve.to_rows32(points)
    return plan


def _attach_ches_params(plan: MsmPlan, cfg: P.MsmConfig, device) -> None:
    """Config-derived digit tables (index-keyed pairs and value-keyed) and
    bucket-gap constants (host-cheap)."""
    plan.packed_table = torch.as_tensor(
        P.packed_digit_table_pairs(cfg.q, cfg.ah), device=device)
    plan.packed_table_value = torch.as_tensor(
        P.packed_digit_table_value(cfg.q, cfg.ah), device=device)
    bs = cfg.bucket_set()
    plan.bucket_gaps = np.diff(bs).astype(np.int32)
    if plan.bucket_gaps.max() > cfg.d_max:
        raise ValueError(f"bucket gap {plan.bucket_gaps.max()} exceeds "
                         f"d_max={cfg.d_max}")
    plan.gap_groups = gap_groups(plan.bucket_gaps, device)

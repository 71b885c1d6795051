"""K3 and K4: the level kernels of the prefix-scan bucket pipeline
(csrc/scan.cu) and their plain twins.

K3 `affine_prefix_level` replaces msm_blst_tpu/msm/pallas_scan.py
_affine_prefix_kernel (via affine_prefix_level): the level-1 inclusive
prefix of a signed affine stream down `c` columns per lane, emitting every
local prefix as a row (X||Y||ZZZ||ZZ words) and each lane's xyzz tail.

K4 `xyzz_scan_level` replaces pallas_scan.py _scan_kernel (via
prefix_scan_xyzz): the same over an xyzz stream in column layout.
`prefix_scan_xyzz` keeps the JAX structure around it — `_shape_stream`,
the level, then the chunk-tail carry combine in plain scans plus one wide
K2 dadd — so its intermediates match the JAX package's.

On a CUDA tensor every call goes through its kernel: the TPU launch-cost
thresholds (MIN_LEVEL_N, MIN_SCAN_N, prefix_available) gate nothing here.
CPU tensors take the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.ops import AffinePoint, XyzzPoint
from ..kernels import Kernel, check_cuda, ptr
from ..utils import scans

AFFINE_PREFIX = Kernel("msm_affine_prefix_level")
XYZZ_SCAN = Kernel("msm_xyzz_scan_level")


def _shape_stream(N: int, c_target: int = 32):
    """(columns, lanes) for a stream of N elements, as the JAX package
    picks them: lanes a power of two >= 128, ~c_target columns."""
    n_ch = max(128, 1 << max(int(np.floor(np.log2(max(N // c_target, 1)))), 0))
    return max(2, -(-N // n_ch)), n_ch


def _require_g1(curve):
    if curve.name != "G1" or curve.F.n_words != 12:
        raise NotImplementedError("the CUDA scan kernels are built for G1")


# ---- K3 -----------------------------------------------------------------------


def affine_prefix_level_plain(curve, rows_x, rows_y, sgn_cols):
    """Plain K3: rows (c, n_ch, W) int32 x2, signs (c, n_ch) ->
    (local rows int32 (c, n_ch, 4W), tails XyzzPoint of (W, n_ch))."""
    F = curve.F.plain
    c = rows_x.shape[0]
    X = rows_x.permute(0, 2, 1)
    Y = rows_y.permute(0, 2, 1)
    sub = sgn_cols != 0
    run = curve.xyzz_from_affine(AffinePoint(X[0], Y[0]), negate=sub[0])
    locs = [run]
    for j in range(1, c):
        run = curve.xyzz_dadd_affine_body(run, AffinePoint(X[j], Y[j]),
                                          subtract=sub[j], F=F)
        locs.append(run)
    local = torch.cat([torch.stack([p[i] for p in locs]) for i in range(4)],
                      dim=1)  # (c, 4W, n_ch)
    return local.permute(0, 2, 1).contiguous(), run


def affine_prefix_level(curve, rows_x, rows_y, sgn_cols):
    """Level-1 prefix over gathered table rows (c, n_ch, W) x2 and signs
    (c, n_ch). Returns (local rows int32 (c, n_ch, 4W) — the four xyzz
    coordinates per stream element — and tails XyzzPoint of (W, n_ch))."""
    if rows_x.device.type == "cpu":
        return affine_prefix_level_plain(curve, rows_x, rows_y, sgn_cols)
    _require_g1(curve)
    c, n_ch, W = rows_x.shape
    if rows_y.shape != rows_x.shape or tuple(sgn_cols.shape) != (c, n_ch):
        raise ValueError("affine_prefix_level: shapes "
                         f"{tuple(rows_x.shape)} {tuple(rows_y.shape)} "
                         f"{tuple(sgn_cols.shape)}")
    sgn = sgn_cols.to(torch.int32).contiguous()
    check_cuda("affine_prefix_level", (rows_x, rows_y, sgn))
    local = torch.empty((c, n_ch, 4 * W), dtype=torch.int32,
                        device=rows_x.device)
    tails = [torch.empty((W, n_ch), dtype=torch.int32, device=rows_x.device)
             for _ in range(4)]
    AFFINE_PREFIX(ptr(rows_x), ptr(rows_y), ptr(sgn), ptr(local),
                  *map(ptr, tails), c, n_ch)
    return local, XyzzPoint(*tails)


# ---- K4 -----------------------------------------------------------------------


def xyzz_scan_level_plain(curve, cols: XyzzPoint):
    """Plain K4: coordinates (c, W, n_ch) -> (inclusive scans down the
    columns, same shape; tails XyzzPoint of (W, n_ch))."""
    F = curve.F.plain
    c = cols.X.shape[0]
    run = XyzzPoint(*(x[0] for x in cols))
    outs = [run]
    for j in range(1, c):
        run = curve.xyzz_dadd_body(run, XyzzPoint(*(x[j] for x in cols)), F=F)
        outs.append(run)
    return XyzzPoint(*(torch.stack([o[i] for o in outs]) for i in range(4))), run


def xyzz_scan_level(curve, cols: XyzzPoint):
    """Inclusive xyzz prefix down the columns of (c, W, n_ch) coordinates.
    Returns (scans of the same shape, tails XyzzPoint of (W, n_ch))."""
    if cols.X.device.type == "cpu":
        return xyzz_scan_level_plain(curve, cols)
    _require_g1(curve)
    ins = [x.contiguous() for x in cols]
    check_cuda("xyzz_scan_level", ins)
    if any(x.shape != ins[0].shape for x in ins) or ins[0].ndim != 3:
        raise ValueError("xyzz_scan_level: coordinates must share a "
                         "(c, W, n_ch) shape")
    c, W, n_ch = ins[0].shape
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    tails = [torch.empty((W, n_ch), dtype=torch.int32, device=ins[0].device)
             for _ in range(4)]
    XYZZ_SCAN(*map(ptr, ins + outs + tails), c, n_ch)
    return XyzzPoint(*outs), XyzzPoint(*tails)


def prefix_scan_xyzz(curve, pts: XyzzPoint) -> XyzzPoint:
    """Inclusive prefix scan over a 1-D xyzz batch (W, N): one level in
    column layout, then the chunk-tail carry combine (as utils/scans
    prefix_scan) with one wide dadd."""
    N = pts.X.shape[-1]
    c, n_ch = _shape_stream(N)
    pad = n_ch * c - N

    def to_cols(x):  # (W, N) -> (c, W, n_ch); column j = elements k*c + j
        x = scans.pad_last(x, pad)
        return x.reshape(x.shape[0], n_ch, c).permute(2, 0, 1).contiguous()

    level, tails = xyzz_scan_level(curve, XyzzPoint(*map(to_cols, pts)))
    stream = XyzzPoint(*(x.permute(1, 2, 0).reshape(x.shape[1], -1)
                         for x in level))  # index k*c + j
    if n_ch > 1:
        tails_scan = scans.prefix_scan(curve.xyzz_dadd, tails)
        carry = XyzzPoint(*(x[..., :-1].repeat_interleave(c, dim=-1)
                            for x in tails_scan))
        head = XyzzPoint(*(x[..., :c] for x in stream))
        rest = XyzzPoint(*(x[..., c:] for x in stream))
        combined = curve.xyzz_dadd(carry, rest)
        stream = XyzzPoint(*(torch.cat([h, r], dim=-1)
                             for h, r in zip(head, combined)))
    return XyzzPoint(*(x[..., :N] for x in stream))

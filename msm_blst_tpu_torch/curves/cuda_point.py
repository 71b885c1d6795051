"""K2: the fused xyzz point formulas (csrc/point_ops.cu for G1,
csrc/point_ops_g2.cu for G2) and their plain twins.

Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, op), entered
through `dispatch`: one launch runs a whole formula — `dadd_affine` (signed
madd-2008-s), `dadd` (add-2008-s) or `double` (dbl-2008-s-1) — with its
case analysis, one thread per lane. The kernel is chosen by the curve.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. The plain versions are the formula bodies of
curves/ops.py run with the field's plain twin, so on the card they use no
kernel either.
"""

from __future__ import annotations

import torch

from ..kernels import CURVE_KERNELS, check_cuda, on_cpu, ptr


def _flat(curve, coords, batch):
    """Coordinates broadcast to `batch`, as contiguous (W, B) word batches
    (for G2 the (2, 12, B) column layout the kernel reads)."""
    lead, W = curve.F.lead, curve.F.n_words
    return [c.expand(lead + batch).reshape(W, -1).contiguous() for c in coords]


def _launch(curve, op, ins, extra, batch):
    kernel = CURVE_KERNELS[curve.name]["point_" + op]
    check_cuda(kernel.symbol, ins + extra)
    B = ins[0].shape[1]
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    if B:
        kernel(*map(ptr, ins + extra + outs), B)
    from .ops import XyzzPoint

    return XyzzPoint(*(o.reshape(curve.F.lead + batch) for o in outs))


def _batch(curve, *coords):
    return tuple(torch.broadcast_shapes(*(curve.bshape(c) for c in coords)))


def xyzz_dadd_affine_plain(curve, p1, p2, subtract=None):
    return curve.xyzz_dadd_affine_body(p1, p2, subtract, F=curve.F.plain)


def xyzz_dadd_plain(curve, p1, p2):
    return curve.xyzz_dadd_body(p1, p2, F=curve.F.plain)


def xyzz_double_plain(curve, p):
    return curve.xyzz_double_body(p, F=curve.F.plain)


def xyzz_dadd_affine(curve, p1, p2, subtract=None):
    """p1 +- p2 (xyzz plus affine), per-lane sign mask `subtract`."""
    if on_cpu(*p1, *p2):
        return xyzz_dadd_affine_plain(curve, p1, p2, subtract)
    extra_shape = () if subtract is None else tuple(subtract.shape)
    batch = tuple(torch.broadcast_shapes(_batch(curve, *p1, *p2), extra_shape))
    ins = _flat(curve, list(p1) + list(p2), batch)
    if subtract is None:
        sign = torch.zeros(ins[0].shape[1], dtype=torch.int32,
                           device=ins[0].device)
    else:
        sign = subtract.expand(batch).reshape(-1).to(torch.int32).contiguous()
    return _launch(curve, "dadd_affine", ins, [sign], batch)


def xyzz_dadd(curve, p1, p2):
    """p1 + p2 (xyzz)."""
    if on_cpu(*p1, *p2):
        return xyzz_dadd_plain(curve, p1, p2)
    batch = _batch(curve, *p1, *p2)
    return _launch(curve, "dadd", _flat(curve, list(p1) + list(p2), batch), [],
                   batch)


def xyzz_double(curve, p):
    """2 p (xyzz)."""
    if on_cpu(*p):
        return xyzz_double_plain(curve, p)
    batch = _batch(curve, *p)
    return _launch(curve, "double", _flat(curve, list(p), batch), [], batch)

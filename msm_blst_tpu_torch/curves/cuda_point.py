"""K2: the fused G1 xyzz point formulas (csrc/point_ops.cu) and their plain
twins.

Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, op), entered
through `dispatch`: one launch runs a whole formula — `dadd_affine` (signed
madd-2008-s), `dadd` (add-2008-s) or `double` (dbl-2008-s-1) — with its
case analysis, one thread per lane.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. The plain versions are the formula bodies of
curves/ops.py run with the field's plain twin, so on the card they use no
kernel either.
"""

from __future__ import annotations

import torch

from ..kernels import Kernel, check_cuda, ptr

DADD_AFFINE = Kernel("msm_xyzz_dadd_affine")
DADD = Kernel("msm_xyzz_dadd")
DOUBLE = Kernel("msm_xyzz_double")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _flat(curve, coords, batch):
    """Coordinates broadcast to `batch`, as contiguous (W, B) batches."""
    W = curve.F.n_words
    return [c.expand((W,) + batch).reshape(W, -1).contiguous() for c in coords]


def _launch(kernel, curve, ins, extra, batch):
    if curve.name != "G1" or curve.F.n_words != 12:
        raise NotImplementedError("the CUDA point kernels are built for G1")
    check_cuda(kernel.symbol, ins + extra)
    B = ins[0].shape[1]
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    if B:
        kernel(*map(ptr, ins + extra + outs), B)
    from .ops import XyzzPoint

    W = curve.F.n_words
    return XyzzPoint(*(o.reshape((W,) + batch) for o in outs))


def _batch(*coords):
    return tuple(torch.broadcast_shapes(*(c.shape[1:] for c in coords)))


def xyzz_dadd_affine_plain(curve, p1, p2, subtract=None):
    return curve.xyzz_dadd_affine_body(p1, p2, subtract, F=curve.F.plain)


def xyzz_dadd_plain(curve, p1, p2):
    return curve.xyzz_dadd_body(p1, p2, F=curve.F.plain)


def xyzz_double_plain(curve, p):
    return curve.xyzz_double_body(p, F=curve.F.plain)


def xyzz_dadd_affine(curve, p1, p2, subtract=None):
    """p1 +- p2 (xyzz plus affine), per-lane sign mask `subtract`."""
    if _on_cpu(*p1, *p2):
        return xyzz_dadd_affine_plain(curve, p1, p2, subtract)
    extra_shape = () if subtract is None else tuple(subtract.shape)
    batch = tuple(torch.broadcast_shapes(_batch(*p1, *p2), extra_shape))
    ins = _flat(curve, list(p1) + list(p2), batch)
    if subtract is None:
        sign = torch.zeros(ins[0].shape[1], dtype=torch.int32,
                           device=ins[0].device)
    else:
        sign = subtract.expand(batch).reshape(-1).to(torch.int32).contiguous()
    return _launch(DADD_AFFINE, curve, ins, [sign], batch)


def xyzz_dadd(curve, p1, p2):
    """p1 + p2 (xyzz)."""
    if _on_cpu(*p1, *p2):
        return xyzz_dadd_plain(curve, p1, p2)
    batch = _batch(*p1, *p2)
    return _launch(DADD, curve, _flat(curve, list(p1) + list(p2), batch), [],
                   batch)


def xyzz_double(curve, p):
    """2 p (xyzz)."""
    if _on_cpu(*p):
        return xyzz_double_plain(curve, p)
    batch = _batch(*p)
    return _launch(DOUBLE, curve, _flat(curve, list(p), batch), [], batch)

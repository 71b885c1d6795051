"""Carry-over between the JAX package's layouts and the port's.

JAX holds an Fp batch as `uint32[24, *batch]` 16-bit limbs; the port as
`int32[12, *batch]` 32-bit words with the same bits (word k = limb 2k |
limb 2k+1 << 16). An Fp2 batch is the same per component, component axis
in front: `uint32[2, 24, *batch]` against `int32[2, 12, *batch]`. Both use
R = 2^384, so a Montgomery residue converts without arithmetic. Everything
here takes and returns numpy arrays on the JAX side, so it never imports
jax.
"""

from __future__ import annotations

import numpy as np
import torch

from .curves.curve import G1
from .curves.ops import AffinePoint, PackedRows32
from .device import resolve
from .msm import params as P
from .msm.engine import MsmPlan, gap_groups


def fp_from_jax(limbs: np.ndarray, device=None) -> torch.Tensor:
    """np.uint32[2W, *batch] 16-bit limbs -> torch.int32[W, *batch] words on
    `device` (default: the card)."""
    a = np.asarray(limbs).astype(np.uint32)
    words = a[0::2] | (a[1::2] << np.uint32(16))
    return torch.as_tensor(np.ascontiguousarray(words).view(np.int32),
                           device=resolve(device))


def fp_to_jax(words: torch.Tensor) -> np.ndarray:
    """torch.int32[W, *batch] words -> np.uint32[2W, *batch] 16-bit limbs."""
    w = words.detach().cpu().numpy().view(np.uint32)
    out = np.empty((2 * w.shape[0],) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out


def fp2_from_jax(limbs: np.ndarray, device=None) -> torch.Tensor:
    """np.uint32[2, 2W, *batch] -> torch.int32[2, W, *batch] on `device`
    (default: the card)."""
    a = np.asarray(limbs)
    return torch.stack([fp_from_jax(a[0], device), fp_from_jax(a[1], device)])


def fp2_to_jax(words: torch.Tensor) -> np.ndarray:
    """torch.int32[2, W, *batch] -> np.uint32[2, 2W, *batch]."""
    return np.stack([fp_to_jax(words[0]), fp_to_jax(words[1])])


def _rows(xy, curve, device) -> PackedRows32:
    xy = np.array(xy, dtype=np.uint32)  # a writable copy
    if xy.ndim != 2 or xy.shape[1] != 2 * curve.F.n_words:
        raise ValueError(f"expected PackedRows32 rows, got {xy.shape}")
    return PackedRows32(torch.as_tensor(xy.view(np.int32), device=device))


def plan_from_jax(arrays: dict, cfg: P.MsmConfig, curve=G1,
                  device=None) -> MsmPlan:
    """A port MsmPlan computing the same MSMs as a JAX plan, on `device`
    (default: the card).

    `arrays` holds the JAX plan's fields as numpy arrays, each optional:
    "table3nh" (its PackedRows32 `XY`, uint32[3nh, 2W], W = 12 words per
    coordinate on G1, 24 on G2) with "packed_table" (the pairs layout,
    int32[q+1, 2]) and "bucket_gaps" (int32[B-1]) for CHES; "table_nh"
    (uint32[nh, 2W]) and "bgmw_stride3" (bool) for BGMW; "points" (its (X,
    Y) limb arrays, uint32[24, n] or uint32[2, 24, n] each) for stock;
    "layout" (the JAX plan's row order: "i", the default, or "j" of its
    streamed builders); "noindexhash" (bool) with "packed_table_value"
    (int32[q+1]) for the value-keyed CHES query."""
    device = resolve(device)
    layout = str(arrays.get("layout", "i"))
    if layout not in ("i", "j"):
        raise ValueError(f"layout must be 'i' or 'j', got {layout!r}")
    plan = MsmPlan(curve=curve, cfg=cfg, layout=layout,
                   bgmw_stride3=bool(arrays.get("bgmw_stride3", False)),
                   noindexhash=bool(arrays.get("noindexhash", False)))
    if arrays.get("table3nh") is not None:
        plan.table3nh = _rows(arrays["table3nh"], curve, device)
        packed = np.array(arrays["packed_table"], dtype=np.int32)
        if packed.ndim != 2:
            raise ValueError("packed_table: expected the pairs layout (q+1, 2)")
        plan.packed_table = torch.as_tensor(packed, device=device)
        if arrays.get("packed_table_value") is not None:
            value = np.array(arrays["packed_table_value"], dtype=np.int32)
            if value.ndim != 1:
                raise ValueError("packed_table_value: expected int32[q+1]")
            plan.packed_table_value = torch.as_tensor(value, device=device)
        plan.bucket_gaps = np.array(arrays["bucket_gaps"], dtype=np.int32)
        plan.gap_groups = gap_groups(plan.bucket_gaps, device)
    if arrays.get("table_nh") is not None:
        plan.table_nh = _rows(arrays["table_nh"], curve, device)
    if arrays.get("points") is not None:
        from_jax = fp2_from_jax if curve.name == "G2" else fp_from_jax
        plan.points = AffinePoint(*(from_jax(c, device)
                                    for c in arrays["points"]))
        plan.points_rows = curve.to_rows32(plan.points)
    return plan

"""K2: the fused xyzz point formulas (csrc/point_ops.cu for G1,
csrc/point_ops_g2.cu for G2) and their plain twins.

Replaces msm_blst_tpu/curves/pallas_point.py _kernel(curve, op), entered
through `dispatch`: one launch runs a whole formula — `dadd_affine` (signed
madd-2008-s), `dadd` (add-2008-s) or `double` (dbl-2008-s-1) — with its
case analysis, one thread per lane. The kernel is chosen by the curve, and
its Montgomery products run on the card's carry chains (csrc/k2_mul.cuh).
Two more launches run the CHES query's own formula steps, each in one
kernel: `bucket_diffs`, the bucket sums as differences of the prefix
level's boundary sums (prefix_pipeline.buckets_from_boundaries), and
`gap_horner`, the Horner combine of the folded gap groups
(engine.integrate_gapped).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors. The plain versions are the formula bodies of
curves/ops.py run with the field's plain twin, so on the card they use no
kernel either; `bucket_diffs_plain` and `gap_horner_plain` are the torch
code the two new kernels replace, on those bodies.
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
        kernel(*map(ptr, ins + extra + outs), B, batch=B)
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


def bucket_diffs_plain(curve, right, local, incl, c: int, n_ch: int):
    """The bucket sums of a key-sorted stream from its prefix level: bucket
    k is P(right_k) + (-P(right_{k-1})), P(i) = excl[kch] + local row
    (j, kch) of the element i - 1 = kch c + j, excl the exclusive scan of
    the lane tails (incl shifted by one lane), P(0) and P(right_{-1})
    infinity. `right`: int32 (n_buckets,); `local`: (c, n_ch, 4W) rows;
    `incl`: the tails' inclusive scan, an XyzzPoint (*F.lead, n_ch)."""
    from .ops import XyzzPoint

    F = curve.F
    W = F.n_words
    dev = right.device
    inf1 = curve.xyzz_inf((1,), dev)
    excl = XyzzPoint(*(torch.cat([z, x[..., :-1]], dim=-1)
                       for z, x in zip(inf1, incl)))
    rows = local.reshape(c * n_ch, 4 * W)
    idx1 = right.to(torch.int64)
    pos = torch.clamp(idx1 - 1, min=0)
    kch = torch.div(pos, c, rounding_mode="floor")
    j = pos - kch * c
    g = rows.index_select(0, j * n_ch + kch)  # (B, 4W)
    loc = XyzzPoint(*(curve.from_words(x.T) for x in torch.split(g, W, dim=1)))
    val = xyzz_dadd_plain(curve, curve.take(excl, kch), loc)
    pe = curve.select(idx1 == 0, curve.xyzz_inf(idx1.shape, dev), val)
    ps = XyzzPoint(*(torch.cat([z, x[..., :-1]], dim=-1)
                     for z, x in zip(inf1, pe)))
    ps_neg = XyzzPoint(ps.X, F.plain.neg(ps.Y), ps.ZZZ, ps.ZZ)
    return xyzz_dadd_plain(curve, pe, ps_neg)


def bucket_diffs(curve, right, local, incl, c: int, n_ch: int):
    """bucket_diffs_plain's bucket sums, an XyzzPoint (*F.lead,
    n_buckets): one launch for CUDA tensors."""
    from .ops import XyzzPoint

    if on_cpu(right, local, *incl):
        return bucket_diffs_plain(curve, right, local, incl, c, n_ch)
    kernel = CURVE_KERNELS[curve.name]["point_bucket_diffs"]
    lead, W = curve.F.lead, curve.F.n_words
    if local.numel() != c * n_ch * 4 * W or any(
            tuple(x.shape) != lead + (n_ch,) for x in incl):
        raise ValueError(f"{kernel.symbol}: expected ({c}, {n_ch}, {4 * W}) "
                         f"local rows and {lead + (n_ch,)} tail sums")
    if right.dim() != 1:
        raise ValueError(f"{kernel.symbol}: expected a 1-D right boundary")
    rows = local.reshape(c * n_ch, 4 * W).contiguous()
    if rows.data_ptr() % 16:  # the kernel copies rows in 16-byte words
        rows = rows.clone()
    ins = [x.reshape(W, n_ch).contiguous() for x in incl]
    check_cuda(kernel.symbol, [right, rows] + ins)
    nb = right.shape[0]
    outs = [torch.empty((W, nb), dtype=torch.int32, device=right.device)
            for _ in range(4)]
    if nb:
        kernel(ptr(right), ptr(rows), *map(ptr, ins + outs), c, n_ch, nb)
    return XyzzPoint(*(o.reshape(lead + (nb,)) for o in outs))


def gap_horner_plain(curve, sums, present):
    """sum_g g S_g over the folded gap groups `sums` (*F.lead, d_max), group
    g in column g - 1, of those with present[g - 1]: by Horner over the bits
    of g from the top, each bit's part the sum of its groups in ascending g;
    no doubling before the first part; infinity if no group is present.
    Returns (*F.lead, 1)."""
    from .ops import XyzzPoint

    parts = [XyzzPoint(*(c[..., g:g + 1] for c in sums)) if p else None
             for g, p in enumerate(present)]
    acc = None
    d_max = len(parts)
    for bit in range(d_max.bit_length() - 1, -1, -1):
        sel = [s for g, s in enumerate(parts, start=1)
               if ((g >> bit) & 1) and s is not None]
        part = None
        if sel:
            part = sel[0]
            for s in sel[1:]:
                part = xyzz_dadd_plain(curve, part, s)
        if acc is not None:
            acc = xyzz_double_plain(curve, acc)
            if part is not None:
                acc = xyzz_dadd_plain(curve, acc, part)
        else:
            acc = part
    if acc is None:
        return curve.xyzz_inf((1,), sums.X.device)
    return acc


def gap_horner(curve, sums, present):
    """gap_horner_plain's sum: one launch for CUDA tensors, the groups'
    parts in a thread a bit of g, then the Horner chain in one thread."""
    from .ops import XyzzPoint

    if on_cpu(*sums):
        return gap_horner_plain(curve, sums, present)
    kernel = CURVE_KERNELS[curve.name]["point_gap_horner"]
    lead, W = curve.F.lead, curve.F.n_words
    d_max = len(present)
    if not 1 <= d_max < 64 or any(tuple(x.shape) != lead + (d_max,)
                                  for x in sums):
        raise ValueError(f"{kernel.symbol}: expected 1 to 63 groups of "
                         f"{lead} coordinates, got {len(present)}")
    ins = [x.contiguous().reshape(W, d_max) for x in sums]
    check_cuda(kernel.symbol, ins)
    mask = sum(1 << g for g, p in enumerate(present) if p)
    outs = [torch.empty((W, 1), dtype=torch.int32, device=ins[0].device)
            for _ in range(4)]
    kernel(*map(ptr, ins + outs), mask, d_max)
    return XyzzPoint(*(o.reshape(lead + (1,)) for o in outs))

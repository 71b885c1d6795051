"""Time the whole inclusive xyzz prefix scan, `prefix_scan_xyzz`, the
whole prefix-scan bucket accumulation, `prefix_pipeline.bucket_sums_prefix`
with K3 alone at its level, and the whole segmented bucket reduction,
`scan.segmented_reduce_affine` (K5), of one checkout of the port on the
card.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/scan_timing.py [--tree DIR] [--out report.json]

`--tree` names the root of another checkout whose `msm_blst_tpu_torch` is
timed instead of this one's, so that two versions are timed by one
script with one timer: run it once a tree, alternating, in one session on
one card. `prefix_scan_xyzz` is looked up in `msm/scan.py` and, for
checkouts older than the block scan, in `msm/cuda_scan.py` (the column
walk with its chunk-tail scan and carry). Each call is timed whole, with
`utils/profiling.device_ms` (CUDA events around back-to-back calls, so
host issue counts where it is slower than the card), on G1 and G2.

* `prefix_scan_xyzz` at the stream lengths of the query paths at n = 2^16:
  109,243 (the CHES integration's suffix scan), 32,768 and 16,384 (the K3
  level's lane tails of CHES and BGMW, and of a stock window), 8,192 and
  2,048 (the tails of the level's earlier shape) and 64 (stock); the
  stream is the first N of one 109,243-point xyzz batch: doubled lifts of
  64 fixed points drawn with a numpy seed.
* `bucket_sums_prefix` (the K3 level, K4 over its lane tails, the bucket
  boundaries) on the key-sorted digit streams of one recode at
  params.CONFIGS[16] of scalars from a numpy seed: CHES's 917,504 digits
  (host recode) over its 109,244 buckets, BGMW95's 983,040 (device recode,
  the r - a fold) over 65,537, and the first window of stock Pippenger's
  (window 13) 65,536 over 4,097. The table rows are the 2^16 fixed points'
  repeated to the table's length (3nh, nh and n rows), so that each slot
  reads a curve point without a plan build. Beside it, K3 alone
  (`cuda_scan.affine_prefix_level`) at the level shape the checkout's
  `prefix_pipeline.stream_shape` gives the stream, on the gathered rows.
* `segmented_reduce_affine` (the segmented strategy's bucket sums: K5's
  levels and whatever the checkout runs after them) on BGMW's and the
  stock window's streams, from their gathered rows, as
  `engine._bucket_sums_stream` hands them over; beside it K5's affine
  level alone (`cuda_scan.seg_level`, whose arguments every checkout
  shares) on those rows at the JAX package's level shape (BGMW (60,
  16,384): 128 blocks, about one an SM; stock (32, 2,048)) and at this
  checkout's (SEG_SHAPES: (30, 32,768), 256 blocks, two an SM; (4,
  16,384)).

Prints the card's name and power limit, the checkout's K3 and K5
registers and the resident blocks of its kernels (where it reports them),
one line a measurement and one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import json

import numpy as np
import torch

from timing_tools import ROOT, card, use_tree

LENGTHS = (109243, 32768, 16384, 8192, 2048, 64)
# K5's level shapes timed on each segmented stream: the JAX package's, then
# cuda_scan.seg_level_shape's at CONFIGS[16]
SEG_SHAPES = {"bgmw": ((60, 16384), (30, 32768)),
              "stock": ((32, 2048), (4, 16384))}
REPS = 10
SEED = 0
N_LOG = 16
STOCK_WINDOW = 13


def _scan_fn(tree: str):
    for mod in ("scan", "cuda_scan"):
        m = importlib.import_module(f"msm_blst_tpu_torch.msm.{mod}")
        if hasattr(m, "prefix_scan_xyzz"):
            return m.__name__, m.prefix_scan_xyzz
    raise SystemExit(f"{tree}: no prefix_scan_xyzz in msm/scan.py or "
                     "msm/cuda_scan.py")


def _streams(dev):
    """The three digit streams of one recode at CONFIGS[16], key-sorted:
    {name: (slots, signs, keys, n_buckets, table rows)}."""
    from msm_blst_tpu_torch.msm import engine, params, recode

    cfg = params.CONFIGS[N_LOG]
    n = 1 << N_LOG
    host = recode.random_scalars(n, SEED)
    scalars = recode.to_device(host, dev)
    out = {}
    b, m, s = recode.ches_recode_host(host, cfg.c, cfg.h, cfg.ah)
    keys = params.bucket_value_to_index(cfg.q, cfg.ah)[b]
    slots = engine.ches_slots(np.arange(n)[:, None], np.arange(cfg.h)[None, :],
                              m - 1, cfg.h)
    out["ches"] = (torch.as_tensor(slots.reshape(-1), device=dev),
                   torch.as_tensor(s.reshape(-1), device=dev),
                   torch.as_tensor(keys.reshape(-1), device=dev),
                   cfg.b_size, 3 * n * cfg.h)
    sc = recode.reduce_mod_r_device(scalars)
    sc, flip = recode.fold_r_minus_a_device(sc)
    absd, sign = recode.signed_digits_device(sc, cfg.c_bgmw, cfg.h_bgmw)
    sign = sign ^ flip[None, :]
    i_idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    j_idx = torch.arange(cfg.h_bgmw, dtype=torch.int32, device=dev)[:, None]
    out["bgmw"] = (engine.bgmw_slots(i_idx, j_idx, cfg.h_bgmw).reshape(-1),
                   sign.reshape(-1), absd.reshape(-1),
                   (cfg.q_bgmw >> 1) + 1, n * cfg.h_bgmw)
    h = -(-256 // STOCK_WINDOW)
    absd, sign = recode.signed_digits_device(scalars, STOCK_WINDOW, h)
    out["stock"] = (torch.arange(n, dtype=torch.int32, device=dev), sign[0],
                    absd[0], (1 << (STOCK_WINDOW - 1)) + 1, n)
    sorted_streams = {}
    for name, (slots, signs, keys, n_buckets, rows) in out.items():
        keys_s, perm = torch.sort(keys.to(torch.int32), stable=True)
        sorted_streams[name] = (slots.to(torch.int32)[perm],
                                signs.to(torch.bool)[perm], keys_s,
                                n_buckets, rows)
    return sorted_streams


def _seg_level_ms(cuda_scan, curve, stream, signs, keys, n_buckets, c,
                  n_ch):
    """K5's affine level alone at (c, n_ch) on a key-sorted stream's rows
    (N, 2W): the stream padded with infinity (key n_buckets) and cut into
    n_ch lanes of c columns, as the level's callers cut it."""
    from msm_blst_tpu_torch.utils.profiling import device_ms

    W = curve.F.n_words
    N = keys.shape[0]
    pad = c * n_ch - N
    rows = torch.cat([stream.XY, stream.XY.new_zeros((pad, 2 * W))])
    g = rows.reshape(n_ch, c, 2 * W).transpose(0, 1)
    cols = (g[..., :W].contiguous(), g[..., W:].contiguous())

    def to_cols(x, fill):
        x = torch.cat([x.to(torch.int32), x.new_full((pad,), fill,
                                                     dtype=torch.int32)])
        return x.reshape(n_ch, c).T.contiguous()

    sg, kc = to_cols(signs, 0), to_cols(keys, n_buckets)
    buckets = cuda_scan.bucket_array(curve, n_buckets, keys.device)
    return device_ms(lambda: cuda_scan.seg_level(curve, cols, sg, kc, buckets,
                                                 n_buckets), REPS)


def _k3_report():
    """The checkout's K3 and K5 registers (ptxas) and resident blocks an
    SM."""
    from msm_blst_tpu_torch import kernels

    out = {name: regs for name, regs in kernels.ptxas_summary().items()
           if name.split()[0] in ("scan.cu", "scan_g2.cu", "seg.cu",
                                  "seg_g2.cu")}
    if hasattr(kernels, "occupancy"):
        for curve in kernels.CURVE_KERNELS:
            for op in kernels.OCCUPANCY:
                out[f"occupancy {curve} {op}"] = kernels.occupancy(curve, op)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_timing.py needs a CUDA device")
    tree = use_tree(args.tree)
    where, prefix_scan_xyzz = _scan_fn(tree)
    from msm_blst_tpu_torch.curves import G1, G2, PackedRows32, XyzzPoint
    from msm_blst_tpu_torch.msm import (cuda_scan, fixed_point_list,
                                        prefix_pipeline, scan)
    from msm_blst_tpu_torch.utils.profiling import device_ms

    smi = card()
    print(smi)
    print(f"tree {tree}: {where}.prefix_scan_xyzz")
    dev = torch.device("cuda", 0)
    k3 = _k3_report()
    for name, v in k3.items():
        print(f"K3/K4/K5 {name}: {v}")
    rng = np.random.default_rng(SEED)
    report = {"tree": tree, "module": where,
              "card": smi, "k3": k3, "ms": {}, "bucket_sums_ms": {},
              "k3_ms": {}, "segmented_ms": {}}
    streams = _streams(dev)
    for curve in (G1, G2):
        fixed = fixed_point_list(curve, 1 << N_LOG, device=dev)
        base = curve.xyzz_double(curve.xyzz_from_affine(
            fixed_point_list(curve, 64, device=dev)))
        idx = torch.as_tensor(rng.integers(0, 64, max(LENGTHS)), device=dev)
        pts = XyzzPoint(*(c[..., idx].contiguous() for c in base))
        for N in LENGTHS:
            head = XyzzPoint(*(c[..., :N].contiguous() for c in pts))
            ms = device_ms(lambda: prefix_scan_xyzz(curve, head), REPS)
            report["ms"][f"{curve.name} {N}"] = ms
            print(f"{curve.name} N={N}: {ms:.4f} ms a call (device_ms, "
                  f"{REPS} calls)")
        rows = curve.to_rows32(fixed).XY
        for name, (slots, signs, keys, n_buckets, n_rows) in streams.items():
            table = PackedRows32(rows.repeat(-(-n_rows // rows.shape[0]),
                                             1)[:n_rows].contiguous())
            N = keys.shape[0]
            ms = device_ms(lambda: prefix_pipeline.bucket_sums_prefix(
                curve, table, slots, signs, keys, n_buckets), REPS)
            c, n_ch = prefix_pipeline.stream_shape(N)
            slots_cm, signs_cm = prefix_pipeline.column_major_streams(
                slots, signs, c, n_ch)
            rx, ry = prefix_pipeline.gather_rows(curve, table, slots_cm, c,
                                                 n_ch)
            sg = signs_cm.reshape(c, n_ch)
            k3_ms = device_ms(lambda: cuda_scan.affine_prefix_level(
                curve, rx, ry, sg), REPS)
            key = f"{curve.name} {name} {N}"
            report["bucket_sums_ms"][key] = ms
            report["k3_ms"][key] = {"c": c, "n_ch": n_ch, "ms": k3_ms}
            print(f"{curve.name} {name} N={N} ({n_buckets} buckets): "
                  f"bucket_sums_prefix {ms:.4f} ms a call; K3 alone at "
                  f"(c, n_ch)=({c}, {n_ch}) {k3_ms:.4f} ms (device_ms, "
                  f"{REPS} calls)")
            del rx, ry
            if name != "ches":
                stream = PackedRows32(table.XY.index_select(
                    0, slots.to(torch.int64)))
                seg_ms = device_ms(lambda: scan.segmented_reduce_affine(
                    curve, stream, signs, keys, n_buckets), REPS)
                level_ms = {f"{c}x{n_ch}": _seg_level_ms(
                    cuda_scan, curve, stream, signs, keys, n_buckets, c, n_ch)
                    for c, n_ch in SEG_SHAPES[name]}
                report["segmented_ms"][key] = {"whole": seg_ms,
                                               "level": level_ms}
                print(f"{curve.name} {name} N={N}: segmented_reduce_affine "
                      f"{seg_ms:.4f} ms a call; K5's level alone " + ", ".join(
                          f"({shape}) {ms:.4f} ms"
                          for shape, ms in level_ms.items())
                      + f" (device_ms, {REPS} calls)")
                del stream
            del table
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Where the time of one MSM query goes on the card, per algorithm.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_profile.py [--curve G1|G2] [--n-log 16]
        [--only QUERY ...] [--listing] [--tree DIR] [--out report.json]

Builds one plan over the curve (G1 or G2) with the CHES, BGMW95 and stock
tables at n = 2^n_log (params.CONFIGS[n_log], fixed points
P_i = 2^(i+1) G; only the CHES table when --only names CHES queries
alone), then for each query (CHES with device and with host recoding;
BGMW95 and stock Pippenger with each bucket strategy; --only picks some)
runs one warm-up and one query under torch.profiler.
It prints the query's host wall time, the device time its kernels took,
the idle share (1 - device / wall) and the kernels that took the most
device time, and writes the same as JSON to --out if given. The
profiler adds host time of its own, so the wall and idle share read high;
compare queries with each other, and take query times from chip_smoke.py.

`--listing` also lists every kernel of each query in the order the card
ran them, each with its grid, its device time and the stage of the query
that launched it: the bucket boundaries (`buckets_from_boundaries`, with
K4's scan of the lane tails inside it apart), the d-gap integration
(`integrate_gapped`, with its K4 suffix scan and K9 folds apart; the rest
is its Horner combine), the segmented bucket reduction
(`segmented_reduce_affine`, with its xyzz part apart: K5's segmented scan,
or an older checkout's xyzz levels and two-element merge) or the rest of
the query. Then, by stage, the
device time of K2's launches, of the other hand-written kernels and of
the torch ops (the glue). The stages are marked by wrapping those
functions in `torch.profiler.record_function` from here, so an older
checkout (`--tree`, the root of another checkout timed instead of this
one) is listed the same way.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from timing_tools import ROOT, card, device_us, use_tree

TOP = 6
QUERIES = ("ches_device", "ches_host_recode", "bgmw prefix", "bgmw segmented",
           "stock prefix", "stock segmented")

# The query's stages, by (module, function): the label the listing gives a
# launch made inside it (the innermost stage wins)
STAGES = (("prefix_pipeline", "buckets_from_boundaries", "boundaries"),
          ("prefix_pipeline", "prefix_scan_xyzz", "boundaries/K4 tails"),
          ("engine", "integrate_gapped", "integration"),
          ("engine", "suffix_scan_xyzz", "integration/K4 suffix"),
          ("engine", "fold_segments", "integration/K9 folds"),
          ("engine", "segmented_reduce_affine", "segmented"),
          # the segmented reduction's xyzz stage: K5's chain of xyzz levels
          # and the two-element merge in older checkouts, the segmented
          # block scan in newer ones
          ("scan", "_segmented_reduce_xyzz", "segmented/xyzz"),
          ("cuda_scan", "seg_scan", "segmented/xyzz"))
# The hand-written kernels by the namespace of their symbol in csrc/
KERNEL_NS = (("point_ops::", "K2"), ("block_scan::", "K4"), ("fold::", "K9"),
             ("scan::", "K3"), ("mont", "K1"), ("sos", "K6"), ("seg", "K5"))


def mark_stages():
    """Wrap each function of STAGES, where the checkout has it, in a
    record_function range named by its label."""
    import importlib

    for mod_name, fn_name, label in STAGES:
        mod = importlib.import_module(f"msm_blst_tpu_torch.msm.{mod_name}")
        fn = getattr(mod, fn_name, None)
        if fn is None:
            continue

        def ranged(*a, _fn=fn, _label=label, **k):
            with torch.profiler.record_function(_label):
                return _fn(*a, **k)
        setattr(mod, fn_name, functools.wraps(fn)(ranged))


def kernel_kind(name: str) -> str:
    for ns, kind in KERNEL_NS:
        if ns in name and ("msm::" in name or "msm_" in name):
            return kind
    return "torch"


def launch_listing(prof) -> list:
    """Every kernel of the profiled window, in the card's order: its
    stage (the innermost STAGES range around the host call that launched
    it), kind, name, grid and device µs, from the profiler's trace (each
    kernel joined to its launch by the correlation id)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    evts = trace["traceEvents"] if isinstance(trace, dict) else trace
    labels = {label for _, _, label in STAGES}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in evts
              if e.get("cat") == "user_annotation" and e.get("name") in labels]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evts
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = []
    for e in sorted((e for e in evts if e.get("cat") == "kernel"),
                    key=lambda e: e["ts"]):
        t = launch_ts.get(e["args"].get("correlation"))
        inner = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        stage = min(inner, key=lambda r: r[1] - r[0])[2] if inner else "rest"
        out.append({"stage": stage, "kind": kernel_kind(e["name"]),
                    "kernel": e["name"][:100], "grid": e["args"].get("grid"),
                    "us": float(e["dur"])})
    return out


def stage_sums(listing) -> dict:
    """{stage: {kind: [launches, device ms]}} of a listing."""
    out = {}
    for r in listing:
        k = out.setdefault(r["stage"], {}).setdefault(r["kind"], [0, 0.0])
        k[0] += 1
        k[1] += r["us"] / 1e3
    return out


def k2_report() -> dict:
    """K2's registers, stack and spills (ptxas), and the resident blocks of
    128 threads an SM: queried where the checkout offers it, else from the
    register count (65,536 registers an SM, a thread's count rounded up to
    8, at most 16 blocks of 4 warps in the SM's 64)."""
    from msm_blst_tpu_torch import kernels

    out = {}
    for name, regs in kernels.ptxas_summary().items():
        if name.split()[0] not in ("point_ops.cu", "point_ops_g2.cu"):
            continue
        n = int(regs.split()[0])
        out[name] = {"ptxas": regs,
                     "blocks_by_registers": min(16, 65536 // (-(-n // 8) * 8 * 128))}
    occ = getattr(kernels, "OCCUPANCY", {})
    for curve in ("G1", "G2"):
        for op in occ:
            if op.startswith("point"):
                out[f"occupancy {curve} {op}"] = kernels.occupancy(curve, op)
    return out


def profile_query(fn, listing: bool = False) -> dict:
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # the stages' ranges show on the card's timeline too: not kernels
    labels = {label for _, _, label in STAGES}
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0
               and e.key not in labels]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:TOP]
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / wall_ms,
           "launches": sum(e.count for e in kernels),
           "top": [{"kernel": e.key[:80], "count": e.count,
                    "device_ms": device_us(e) / 1e3} for e in top]}
    if listing:
        out["listing"] = launch_listing(prof)
        out["stages"] = stage_sums(out["listing"])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", choices=("G1", "G2"), default="G1")
    ap.add_argument("--n-log", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--only", nargs="+", choices=QUERIES,
                    help="profile these queries alone")
    ap.add_argument("--listing", action="store_true",
                    help="list every kernel of each query by stage")
    ap.add_argument("--tree", default=ROOT,
                    help="the root of the checkout to profile")
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: torch sees no CUDA device")
    tree = use_tree(args.tree)
    print(card())
    print(f"tree {tree}")

    from msm_blst_tpu_torch import curves
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_bgmw_device, msm_ches_device,
                                        msm_ches_host_recode,
                                        msm_stock_pippenger, params, recode)

    dev = torch.device("cuda", 0)
    n = 1 << args.n_log
    curve = getattr(curves, args.curve)
    only = args.only or QUERIES
    ches_only = all(q.startswith("ches") for q in only)
    if args.listing:
        mark_stages()
        k2 = k2_report()
        for name, v in k2.items():
            print(f"K2 {name}: {v}")
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev),
                      params.CONFIGS[args.n_log], bgmw=not ches_only,
                      stock=not ches_only)
    host = recode.random_scalars(n, args.seed)
    sc = recode.to_device(host, dev)
    queries = {
        "ches_device": lambda: msm_ches_device(plan, sc),
        "ches_host_recode": lambda: msm_ches_host_recode(plan, host),
        "bgmw prefix": lambda: msm_bgmw_device(plan, sc, bucket_impl="prefix"),
        "bgmw segmented": lambda: msm_bgmw_device(plan, sc,
                                                  bucket_impl="segmented"),
        "stock prefix": lambda: msm_stock_pippenger(plan, sc,
                                                    bucket_impl="prefix"),
        "stock segmented": lambda: msm_stock_pippenger(
            plan, sc, bucket_impl="segmented"),
    }
    report = {"device": torch.cuda.get_device_name(0), "card": card(),
              "tree": tree, "curve": args.curve, "n": n, "queries": {}}
    if args.listing:
        report["k2"] = k2
    for name in only:
        r = profile_query(queries[name], args.listing)
        report["queries"][name] = r
        print(f"{name}: wall {r['wall_ms']:.3f} ms, device {r['device_ms']:.3f}"
              f" ms, idle share {r['idle_share']:.3f}, {r['launches']} launches")
        for t in r["top"]:
            print(f"  {t['device_ms']:9.3f} ms {t['count']:6d}x  {t['kernel']}")
        for i, e in enumerate(r.get("listing", ())):
            if e["stage"] != "rest" or e["kind"] == "K2":
                print(f"  launch {i:4d} {e['stage']:22s} {e['kind']:5s} "
                      f"grid {e['grid']} {e['us']:9.3f} us  {e['kernel'][:60]}")
        for stage, kinds in r.get("stages", {}).items():
            print(f"  stage {stage}: " + "; ".join(
                f"{kind} {n}x {ms:.4f} ms" for kind, (n, ms) in kinds.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

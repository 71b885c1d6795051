"""Where the time of one MSM query goes on the card, per algorithm.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_profile.py [--curve G1|G2] [--n-log 16] [--out report.json]

Builds one plan over the curve (G1 or G2) with the CHES, BGMW95 and stock
tables at n = 2^n_log (params.CONFIGS[n_log], fixed points
P_i = 2^(i+1) G), then for each query
(CHES with device and with host recoding; BGMW95 and stock Pippenger with
each bucket strategy) runs one warm-up and one query under torch.profiler.
It prints the query's host wall time, the device time its kernels took,
the idle share (1 - device / wall) and the kernels that took the most
device time, and writes the same as JSON to --out if given. The
profiler adds host time of its own, so the wall and idle share read high;
compare queries with each other, and take query times from chip_smoke.py.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from timing_tools import card, device_us, use_tree

use_tree()

TOP = 6


def profile_query(fn) -> dict:
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:TOP]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "launches": sum(e.count for e in kernels),
            "top": [{"kernel": e.key[:80], "count": e.count,
                     "device_ms": device_us(e) / 1e3} for e in top]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--curve", choices=("G1", "G2"), default="G1")
    ap.add_argument("--n-log", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile: torch sees no CUDA device")
    print(card())

    from msm_blst_tpu_torch import curves
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_bgmw_device, msm_ches_device,
                                        msm_ches_host_recode,
                                        msm_stock_pippenger, params, recode)

    dev = torch.device("cuda", 0)
    n = 1 << args.n_log
    curve = getattr(curves, args.curve)
    plan = build_plan(curve, fixed_point_list(curve, n, device=dev),
                      params.CONFIGS[args.n_log])
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
    report = {"device": torch.cuda.get_device_name(0), "curve": args.curve,
              "n": n, "queries": {}}
    for name, fn in queries.items():
        r = profile_query(fn)
        report["queries"][name] = r
        print(f"{name}: wall {r['wall_ms']:.3f} ms, device {r['device_ms']:.3f}"
              f" ms, idle share {r['idle_share']:.3f}, {r['launches']} launches")
        for t in r["top"]:
            print(f"  {t['device_ms']:9.3f} ms {t['count']:6d}x  {t['kernel']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

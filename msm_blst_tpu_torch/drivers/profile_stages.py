"""Stage-level wall-clock breakdown of the CHES device-recode query (port of
drivers/profile_stages.py).

Times cumulative prefixes of msm_ches_device, so each measurement adds
exactly one stage and the deltas attribute the cost: recode -> sort ->
gather -> prefix level (K3) -> buckets (K4 over the lane tails, the
boundaries' searchsorted, K2's boundary launch) -> integration and the
conversion to Jacobian (the full query). The barrier is
torch.cuda.synchronize() around each timed loop; the first call of each
prefix (the kernels' build on the card) is timed apart as `first_s`.

Run:

    python -m msm_blst_tpu_torch.drivers.profile_stages [--n-exp 10]
        [--reps 3] [--loops 4] [--device cpu]

--n-exp picks params.CONFIGS[n_exp], or make_config(n_exp, c=13, h=20)
where the table has none; --config names one instead (a key of CONFIGS
or 'tiny', as run_msm's). Prints a line a stage and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..curves import G1
from ..device import resolve
from ..msm import (build_plan, cuda_scan, engine, fixed_point_list,
                   integrate_gapped, params, recode)
from ..msm import prefix_pipeline as pp
from ..utils.profiling import sync
from .run_msm import config_of


def stages(plan):
    """[(name, fn(scalars))]: the cumulative prefixes of the CHES query on
    `plan`."""
    curve, cfg = plan.curve, plan.cfg
    table = plan.table3nh

    def stage_recode(sc):
        return engine._ches_streams(plan, sc)

    def stage_sort(sc):
        return engine._sort_stream(*stage_recode(sc))

    def stage_gather(sc):
        keys_s, slots_s, signs_s = stage_sort(sc)
        c, n_ch = pp.stream_shape(keys_s.shape[0])
        slots_cm, signs_cm = pp.column_major_streams(slots_s, signs_s, c,
                                                     n_ch)
        rx, ry = pp.gather_rows(curve, table, slots_cm, c, n_ch)
        return rx, ry, signs_cm.reshape(c, n_ch), keys_s, c, n_ch

    def stage_level(sc):
        rx, ry, sgn, keys_s, c, n_ch = stage_gather(sc)
        local, tails = cuda_scan.affine_prefix_level(curve, rx, ry, sgn)
        return local, tails, keys_s, c, n_ch

    def stage_buckets(sc):
        local, tails, keys_s, c, n_ch = stage_level(sc)
        return pp.buckets_from_boundaries(curve, local, tails, keys_s,
                                          cfg.b_size, c, n_ch)

    def stage_full(sc):
        return curve.xyzz_to_jac(integrate_gapped(curve, stage_buckets(sc),
                                                  plan.gap_groups))

    return [("recode", stage_recode), ("sort", stage_sort),
            ("gather", stage_gather), ("prefix-scan", stage_level),
            ("buckets", stage_buckets), ("integrate+full", stage_full)]


def profile(plan, scalars, reps: int, loops: int) -> dict:
    """Each stage prefix's median ms a call over `reps` timed loops of
    `loops` calls, its delta on the prefix before it and its first call's
    seconds."""
    device = scalars.device
    out, prev = {}, 0.0
    for name, fn in stages(plan):
        t0 = time.perf_counter()
        fn(scalars)
        sync(device)
        first_s = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(loops):
                fn(scalars)
            sync(device)
            ts.append((time.perf_counter() - t0) / loops)
        t = float(np.median(ts)) * 1e3
        out[name] = {"cum_ms": t, "delta_ms": t - prev, "first_s": first_s}
        print(f"{name:>16}: cum {t:9.2f} ms  (+{t - prev:8.2f} ms)  first "
              f"{first_s:6.1f} s")
        prev = t
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-exp", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--loops", type=int, default=4)
    ap.add_argument("--config", default=None,
                    help="a key of params.CONFIGS or 'tiny' (over --n-exp)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    if args.config:
        cfg, n = config_of(args.config)
    else:
        n = 1 << args.n_exp
        cfg = (params.CONFIGS.get(args.n_exp)
               or params.make_config(args.n_exp, c=13, h=20))
    plan = build_plan(G1, fixed_point_list(G1, n, device=device), cfg,
                      ches=True, bgmw=False, stock=False)
    sc = recode.to_device(recode.random_scalars(n, seed=3), device)
    print(f"n=2^{n.bit_length() - 1} c={cfg.c} h={cfg.h} B={cfg.b_size} "
          f"stream={n * cfg.h}")
    record = {"profile": "stages", "n": n, "c": cfg.c, "h": cfg.h,
              "stages": profile(plan, sc, args.reps, args.loops)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

"""MSM benchmark driver (port of drivers/run_msm.py): the analog of the
reference's main_p1.cpp / main_p2.cpp test_pippengers harness (:438-610).

Runs the five MSM methods on the SAME random scalar sets, checks that their
affine results agree (the cross-method bit-exactness oracle; a mismatch
exits 1), and prints the mean wall time a query of each, the pairwise
improvement percentages and the host scalar conversion's share:

  1. CHES q/5 with the host conversion (msm_ches_host_recode);
  2. CHES q/5 with the device conversion (msm_ches_device);
  3. CHES q/5 noindexhash (msm_ches_device on the plan with
     noindexhash=True: buckets keyed by value);
  4. BGMW95 q/2 (msm_bgmw_device);
  5. stock Pippenger, no precomputation (msm_stock_pippenger).

Run:

    python -m msm_blst_tpu_torch.drivers.run_msm --group 1 --config 16 \\
        [--reps 3] [--loops 1] [--cache-dir DIR] [--oracle] [--json] \\
        [--device cpu]

--config takes a key of msm_blst_tpu_torch.msm.params.CONFIGS (8..21,
'16b', ...) or 'tiny' (n = 64, c = 8, h = 32). --oracle also checks the
result against the pure-Python oracle (refimpl; slow at large n). The
completion barrier is torch.cuda.synchronize() around each timed loop
(main_p1.cpp:459-548). --device defaults to the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np

from .. import refimpl
from ..constants import R_ORDER
from ..curves import G1, G2
from ..device import resolve
from ..msm import (build_plan, cache, fixed_point_list, msm_bgmw_device,
                   msm_ches_device, msm_ches_host_recode, msm_stock_pippenger,
                   params, recode)
from ..msm.precompute import (build_bgmw_table,
                              build_bgmw_table_rows_streamed)
from ..utils.profiling import sync

STOCK = "stock Pippenger (no precompute)"
CHES_DEVICE = "CHES q/5 (integral device conversion)"
BGMW = "BGMW95 q/2"
# (name, query(plan, noindexhash plan, host scalars, device scalars))
METHODS = [
    ("CHES q/5 (host conversion)",
     lambda plan, nih, sc_np, sc: msm_ches_host_recode(plan, sc_np)),
    (CHES_DEVICE, lambda plan, nih, sc_np, sc: msm_ches_device(plan, sc)),
    ("CHES q/5 noindexhash",
     lambda plan, nih, sc_np, sc: msm_ches_device(nih, sc)),
    (BGMW, lambda plan, nih, sc_np, sc: msm_bgmw_device(plan, sc)),
    (STOCK, lambda plan, nih, sc_np, sc: msm_stock_pippenger(plan, sc)),
]


def config_of(name: str):
    """(cfg, n) of a --config value."""
    if name == "tiny":
        return params.make_config(6, c=8, h=32, c_bgmw=8, h_bgmw=32), 64
    cfg = params.CONFIGS[int(name) if name.isdigit() else name]
    return cfg, cfg.n


def oracle_point(curve, sc_np: np.ndarray):
    """The oracle's affine MSM of the scalars over the fixed points P_i =
    2^(i+1) G: (sum s_i 2^(i+1) mod r) * G."""
    ints = recode.scalars_to_ints(sc_np)
    total = sum(s * pow(2, i + 1, R_ORDER) for i, s in enumerate(ints))
    return refimpl.CURVES[curve.name].mult(total % R_ORDER)


def load_or_build(curve, cfg, n: int, device, cache_dir=None):
    """The plan of all three tables: from the cache when it holds the 3nh
    table, else built (and cached); a missing nh table (a cache of a
    CHES-only run) is built in the plan's own row layout."""
    t0 = time.perf_counter()
    plan = None
    if cache_dir:
        plan = cache.load_plan(curve, cfg, n, cache_dir, device=device)
        if plan is not None and plan.table3nh is None:
            plan = None
        if plan is not None:
            print(f"# tables loaded from cache in "
                  f"{time.perf_counter() - t0:.1f}s")
    if plan is None:
        points = fixed_point_list(curve, n, device=device)
        plan = build_plan(curve, points, cfg, ches=True, bgmw=True, stock=True)
        sync(device)
        print(f"# precompute (3nh + nh tables) in "
              f"{time.perf_counter() - t0:.1f}s")
        if cache_dir:
            print("# cached ->", cache.save_plan(plan, cache_dir))
    if plan.points is None:
        plan.points = fixed_point_list(curve, n, device=device)
    if plan.points_rows is None:
        plan.points_rows = curve.to_rows32(plan.points)
    if plan.table_nh is None and not plan.bgmw_stride3:
        t0 = time.perf_counter()
        plan.table_nh = (
            build_bgmw_table_rows_streamed(curve, plan.points, cfg)
            if plan.layout == "j"
            else curve.to_rows32(build_bgmw_table(curve, plan.points, cfg)))
        sync(device)
        print(f"# nh (BGMW95) table built in "
              f"{time.perf_counter() - t0:.1f}s")
        if cache_dir:
            cache.save_plan(plan, cache_dir)
    return plan


def main(argv=None, around=None) -> dict:
    """Runs the driver on `argv` (default: the command line) and returns
    the --json record. `around(name)`, when given, is a context manager
    entered around every call of method `name` (warm-up and timed)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", type=int, default=1, choices=(1, 2))
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--reps", type=int, default=3, help="scalar sets (TEST_NUM)")
    ap.add_argument("--loops", type=int, default=1, help="timed reps per set")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)
    around = around or (lambda name: contextlib.nullcontext())

    device = resolve(args.device)
    curve = G1 if args.group == 1 else G2
    cfg, n = config_of(args.config)
    print(f"# group=G{args.group} n=2^{n.bit_length() - 1} c={cfg.c} h={cfg.h} "
          f"|B|={cfg.b_size} c'={cfg.c_bgmw} h'={cfg.h_bgmw}")
    plan = load_or_build(curve, cfg, n, device, args.cache_dir)
    plan_nih = dataclasses.replace(plan, noindexhash=True)

    results = {name: [] for name, _ in METHODS}
    conv_times = []
    for r in range(args.reps):
        sc_np = recode.random_scalars(n, seed=1000 + r)
        sc = recode.to_device(sc_np, device)
        # the host conversion alone (the reference's conversion share)
        t0 = time.perf_counter()
        recode.ches_recode_host(sc_np, cfg.c, cfg.h, cfg.ah)
        conv_times.append(time.perf_counter() - t0)

        coords = []
        for name, fn in METHODS:
            with around(name):
                fn(plan, plan_nih, sc_np, sc)  # warm-up
            sync(device)
            t0 = time.perf_counter()
            out = None
            with around(name):
                for _ in range(args.loops):
                    out = fn(plan, plan_nih, sc_np, sc)
            sync(device)  # one barrier around the loop (main_p1.cpp:459-548)
            results[name].append((time.perf_counter() - t0) / args.loops)
            coords.append(curve.affine_to_ints(curve.jac_to_affine(out))[0])
        for (name, _), c in zip(METHODS, coords):
            if c != coords[0]:
                print(f"!! MISMATCH set {r}: {name} disagrees")
                sys.exit(1)
        if args.oracle:
            if coords[0] != oracle_point(curve, sc_np):
                print(f"!! ORACLE MISMATCH set {r}")
                sys.exit(1)
            print(f"# set {r}: oracle check OK")
        if r == 0:
            x = coords[0][0]
            print(f"# result x = {x if args.group == 1 else x[0]:#x} "
                  "(all methods agree)")

    print()
    means = {}
    for name, _ in METHODS:
        means[name] = float(np.mean(results[name]) * 1e6)
        print(f"{name:42s} {means[name]:12.1f} us/query")
    conv_us = float(np.mean(conv_times) * 1e6)
    base, ches, bgmw = means[STOCK], means[CHES_DEVICE], means[BGMW]
    print(f"{'host scalar conversion':42s} {conv_us:12.1f} us "
          f"({100 * conv_us / max(means[METHODS[0][0]], 1e-9):.1f}% of "
          "method 1)")
    print(f"CHES vs stock Pippenger: {100 * (base - ches) / base:+.1f}% "
          f"| CHES vs BGMW95: {100 * (bgmw - ches) / bgmw:+.1f}%")
    record = {"n": n, "group": args.group, "means_us": means,
              "conversion_us": conv_us}
    if args.json:
        print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

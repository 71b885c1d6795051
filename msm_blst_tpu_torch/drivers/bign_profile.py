"""Stage breakdown of the big-n (bucket-range chunked) query, msm_bign
(port of drivers/bign_profile.py).

Times cumulative prefixes of msm_bign, so the deltas attribute the cost:

  1. recode            (the digit stream: digits and table lookups)
  2. + sort            (engine._sort_stream: the stable key sort)
  3. + segment starts  (the chunk count, segment_starts and the one host
                        read of the starts)
  4. full query        (adds the chunks' gather, prefix level, boundaries
                        and the integration)

The barrier is torch.cuda.synchronize() around each timed loop. The JAX
driver's MSM_SORT_SLOTS (a two-key sort variant) is not ported: the port
has one sort, engine._sort_stream. The plan is built each run, or loaded
from --cache-dir (and saved there) when one is given.

Run:

    python -m msm_blst_tpu_torch.drivers.bign_profile [--n-exp 19]
        [--algo bgmw|ches] [--reps 2] [--loops 2] [--cache-dir DIR]
        [--device cpu]

--n-exp picks params.CONFIGS[n_exp]; --config names a config instead (a
key of CONFIGS or 'tiny', as run_msm's). Prints a line a stage and one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..curves import G1
from ..device import resolve
from ..msm import (build_plan, cache, engine, fixed_point_list, msm_bign,
                   recode)
from ..msm.prefix_pipeline import chunks_for, segment_starts
from ..utils.profiling import sync
from .run_msm import config_of


def stages(plan, algo: str):
    """[(label, fn(scalars))]: the cumulative prefixes of msm_bign."""
    cfg = plan.cfg
    if algo == "ches":
        n_buckets = cfg.b_size

        def streams(sc):
            return engine._ches_streams(plan, sc)
    else:
        n_buckets = (cfg.q_bgmw >> 1) + 1

        def streams(sc):
            return engine._bgmw_streams(plan, sc)[1:]

    def recode_sort(sc):
        return engine._sort_stream(*streams(sc))

    def starts(sc):
        keys_s = recode_sort(sc)[0]
        s, _ = segment_starts(keys_s, n_buckets,
                              chunks_for(plan.curve, keys_s))
        return s.tolist()

    return [("recode", streams), ("recode+sort", recode_sort),
            ("recode+sort+starts", starts),
            ("full query", lambda sc: msm_bign(plan, sc, algo))]


def profile(plan, scalars, algo: str, reps: int, loops: int) -> dict:
    """Each prefix's median ms a call over `reps` timed loops of `loops`
    calls (after one untimed call) and its delta on the prefix before."""
    device = scalars.device
    out, prev = {}, 0.0
    for label, fn in stages(plan, algo):
        fn(scalars)  # warm
        sync(device)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(loops):
                fn(scalars)
            sync(device)
            ts.append((time.perf_counter() - t0) / loops)
        t = float(np.median(ts)) * 1e3
        out[label] = {"cum_ms": t, "delta_ms": t - prev}
        print(f"{label:28s} {t:9.1f} ms  (+{t - prev:8.1f} ms)")
        prev = t
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-exp", type=int, default=19)
    ap.add_argument("--algo", default="bgmw", choices=("ches", "bgmw"))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--loops", type=int, default=2)
    ap.add_argument("--config", default=None,
                    help="a key of params.CONFIGS or 'tiny' (over --n-exp)")
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg, n = config_of(args.config or str(args.n_exp))
    ches = args.algo == "ches"
    t0 = time.perf_counter()
    plan = None
    if args.cache_dir:
        plan = cache.load_plan(G1, cfg, n, args.cache_dir, device=device)
        if plan is not None and (plan.table3nh if ches else plan.table_nh
                                 ) is None:
            plan = None
    if plan is None:
        plan = build_plan(G1, fixed_point_list(G1, n, device=device), cfg,
                          ches=ches, bgmw=not ches, stock=False)
        plan.points = None
        if args.cache_dir:
            cache.save_plan(plan, args.cache_dir)
    sync(device)
    print(f"# setup {time.perf_counter() - t0:.1f}s  n=2^{n.bit_length() - 1} "
          f"algo={args.algo} layout={plan.layout}")
    sc = recode.to_device(recode.random_scalars(n, seed=3), device)
    record = {"profile": "bign", "n": n, "algo": args.algo,
              "stages": profile(plan, sc, args.algo, args.reps, args.loops)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

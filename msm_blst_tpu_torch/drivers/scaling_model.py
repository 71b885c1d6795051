"""Scaling of the points-sharded CHES query over D = 1, 2, 4, 8 ranks (port
of drivers/scaling_model.py).

For each D, D spawned ranks of a process group (parallel.run_ranks) build the
plan at n = 2^nexp with CONFIGS[14]'s radix (c = 16, h = 16, |B| =
18,343), keep their points' shard, and run the sharded query: each rank's
result equal to the oracle (bit-exact in affine), the query's median ms,
and its stages apart (ShardedQuery.stage_ms: the local
accumulation, the all-reduce's exchanges and K2 dadds, the integration).
Rank 0 of the D = 1 run measures the dadd rate at the bucket width (K2
dadd on the card; time_ms). Rank r runs on card r mod the card count,
in an NCCL group where D ranks fit on D cards and in a gloo group where
they share cards: with more ranks than cards these are times of D
processes sharing devices, not of D devices.

With --link-gbs (a link's bandwidth, GB/s; no default) it prints a
projection of the all-reduce, log2(D) rounds of one exchange of the
bucket array (|B| xyzz points, 4 * 48 bytes each) and one |B|-wide dadd at
the measured rate, set against the measured D = 1 query.

Run:

    python -m msm_blst_tpu_torch.drivers.scaling_model [--nexp 13]
        [--ranks 1 2 4 8] [--reps 3] [--link-gbs GBS] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from ..curves import G1
from ..device import resolve
from ..msm import build_plan, fixed_point_list, params, recode
from ..parallel import (make_points_mesh, shard_plan_tables,
                        sharded_msm_ches)
from ..parallel.ranks import group_backend, run_ranks
from ..utils import profiling
from .run_msm import oracle_point

SEED = 77


def config(nexp: int) -> params.MsmConfig:
    """CONFIGS[14]'s radix at n = 2^nexp."""
    c14 = params.CONFIGS[14]
    return params.MsmConfig(nexp, c14.c, c14.h, c14.ah, c14.b_size,
                            c14.c_bgmw, c14.h_bgmw)


def _rank(rank: int, world: int, dev, nexp: int, reps: int) -> dict:
    n, cfg = 1 << nexp, config(nexp)
    mesh = make_points_mesh(world, dev.type)
    plan = shard_plan_tables(build_plan(
        G1, fixed_point_list(G1, n, device=dev), cfg, bgmw=False,
        stock=False), mesh)
    sc_np = recode.random_scalars(n, SEED)
    scalars = recode.to_device(sc_np, dev)
    query = sharded_msm_ches(plan, mesh)
    got = G1.affine_to_ints(G1.jac_to_affine(query(scalars)))[0]
    if got != oracle_point(G1, sc_np):
        raise AssertionError(f"D={world} rank {rank}: sharded result differs "
                             "from the oracle")
    out = query.stage_ms(scalars, reps)
    if rank == 0 and world == 1:
        buckets = query.local(scalars)
        out["dadd_bucket_ms"] = profiling.time_ms(
            lambda: G1.xyzz_dadd(buckets, buckets), dev, reps)
    return out


def project(b_size: int, rate: float, link_gbs: float) -> dict:
    """{D: all-reduce ms} for D = 2, 4, 8: log2(D) rounds of an exchange of
    b_size G1 xyzz points (4 * 48 bytes each) over a link of link_gbs GB/s
    and a b_size-wide dadd at `rate` a second."""
    return {D: (D.bit_length() - 1) * (b_size * 4 * 48 / (link_gbs * 1e9)
                                       + b_size / rate) * 1e3
            for D in (2, 4, 8)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nexp", type=int, default=13)
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--link-gbs", type=float, default=None,
                    help="a link's bandwidth in GB/s, for the projection")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = config(args.nexp)
    print(f"# n=2^{args.nexp} c={cfg.c} h={cfg.h} |B|={cfg.b_size}; device "
          f"{profiling.device_name(device)}")
    rows = {}
    for D in args.ranks:
        t0 = time.perf_counter()
        per_rank = run_ranks(_rank, D, device, (args.nexp, args.reps))
        rows[D] = per_rank
        r0 = per_rank[0]
        print(f"D={D} ({group_backend(device.type, D)}): every rank bit-exact; rank 0 query {r0['total_ms']:.3f}"
              f" ms (local {r0['local_ms']:.3f}, all-reduce "
              f"{r0['allreduce_ms']:.3f} = exchange {r0['exchange_ms']:.3f} + "
              f"dadd {r0['dadd_ms']:.3f} over {r0['rounds']} rounds, "
              f"integration {r0['integrate_ms']:.3f}); "
              f"{time.perf_counter() - t0:.1f} s with the spawn and builds")
    record = {"driver": "scaling_model", "nexp": args.nexp,
              "b_size": cfg.b_size, "device": profiling.device_name(device),
              "ranks": {str(D): r for D, r in rows.items()}}
    if 1 in rows:
        dadd_ms = rows[1][0]["dadd_bucket_ms"]
        rate = cfg.b_size / (dadd_ms / 1e3)
        record["dadd_per_s"] = rate
        print(f"dadd at the bucket width: {dadd_ms:.4f} ms, {rate:.4g}/s")
        if args.link_gbs:
            one = rows[1][0]["total_ms"]
            proj = project(cfg.b_size, rate, args.link_gbs)
            for D, t in proj.items():
                eff = one / D / (one / D + t)
                print(f"projected at {args.link_gbs:g} GB/s a link: D={D} "
                      f"all-reduce {t:.3f} ms, efficiency {100 * eff:.1f}% "
                      "against the measured D=1 query split D ways")
            record["projected"] = {str(D): t for D, t in proj.items()}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

"""The big-n sharding paths at the production radix (port of
drivers/sharded_bign.py).

1. Window-sharded "j" CHES at n = 2^nexp with CONFIGS[16]'s radix (c = 19,
   h = 14, |B| = 109,244) over D ranks (8 by default; h padded to a
   multiple of D): each rank builds the streamed plan and keeps its window
   block, one rank after another (a barrier between; the card's cache
   emptied after each), then the query on every rank against the oracle,
   its stages timed apart (ShardedQuery.stage_ms: local
   accumulation, the all-reduce's exchanges and K2 dadds, integration).
2. The 2-D ("points" x "windows") mesh of D/2 x 2 on an "i" plan at
   CONFIGS[14] (n = 2^14, c = 16, h = 16), against the oracle, timed the
   same way (--skip-2d leaves it out).

The ranks are spawned processes (parallel.run_ranks): rank r on card r mod
the card count, an NCCL group where the D ranks fit on D cards, else gloo;
with more ranks than cards these are times of D processes sharing devices.
Rank 0 measures the dadd rate at the bucket width (K2 dadd; time_ms).
With --link-gbs (a link's bandwidth, GB/s; no default) it prints the
all-reduce projected from that rate and the link for D = 2, 4, 8.

Run:

    python -m msm_blst_tpu_torch.drivers.sharded_bign [--nexp 16]
        [--ranks 8] [--reps 2] [--skip-2d] [--link-gbs GBS] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from ..curves import G1
from ..device import resolve
from ..msm import build_plan, fixed_point_list, params, recode
from ..parallel import (make_2d_mesh, make_windows_mesh, shard_plan_tables,
                        shard_plan_tables_jmajor, sharded_msm_ches_2d,
                        sharded_msm_ches_windows)
from ..parallel.ranks import group_backend, in_turns, run_ranks
from ..utils import profiling
from .run_msm import oracle_point
from .scaling_model import project

SEED, SEED_2D = 99, 101
NEXP_2D = 14


def bign_config(nexp: int) -> params.MsmConfig:
    """CONFIGS[nexp] where there is one, else CONFIGS[16]'s radix, at n =
    2^nexp."""
    base = params.CONFIGS.get(nexp) or params.CONFIGS[16]
    return params.MsmConfig(nexp, base.c, base.h, base.ah, base.b_size,
                            base.c_bgmw, base.h_bgmw)


def _rank(rank: int, world: int, dev, nexp: int, reps: int,
          skip_2d: bool) -> dict:
    n, cfg = 1 << nexp, bign_config(nexp)
    mesh = make_windows_mesh(world, dev.type)

    def build():
        t0 = time.perf_counter()
        plan = build_plan(G1, fixed_point_list(G1, n, device=dev), cfg,
                          bgmw=False, stock=False, streamed=True)
        local = shard_plan_tables_jmajor(plan, mesh)
        del plan
        profiling.sync(dev)
        return local, time.perf_counter() - t0

    plan, build_s = in_turns(rank, world, dev, build)
    sc_np = recode.random_scalars(n, SEED)
    scalars = recode.to_device(sc_np, dev)
    query = sharded_msm_ches_windows(plan, mesh)
    got = G1.affine_to_ints(G1.jac_to_affine(query(scalars)))[0]
    if got != oracle_point(G1, sc_np):
        raise AssertionError(f"rank {rank}: window-sharded CHES differs from "
                             "the oracle")
    out = {"build_s": build_s, "rows": plan.table3nh.XY.shape[0],
           "windows": query.stage_ms(scalars, reps)}
    if rank == 0:
        buckets = query.local(scalars)
        out["dadd_bucket_ms"] = profiling.time_ms(
            lambda: G1.xyzz_dadd(buckets, buckets), dev, reps)
    del plan, query
    if skip_2d or world < 2:
        return out
    n2, c14 = 1 << NEXP_2D, params.CONFIGS[NEXP_2D]
    mesh2 = make_2d_mesh(world // 2, 2, dev.type)
    plan2 = shard_plan_tables(build_plan(
        G1, fixed_point_list(G1, n2, device=dev), c14, bgmw=False,
        stock=False, streamed=False), mesh2)
    sc2_np = recode.random_scalars(n2, SEED_2D)
    sc2 = recode.to_device(sc2_np, dev)
    q2 = sharded_msm_ches_2d(plan2, mesh2)
    got = G1.affine_to_ints(G1.jac_to_affine(q2(sc2)))[0]
    if got != oracle_point(G1, sc2_np):
        raise AssertionError(f"rank {rank}: 2-D mesh CHES differs from the "
                             "oracle")
    out["mesh2d"] = q2.stage_ms(sc2, reps)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nexp", type=int, default=16)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--skip-2d", action="store_true")
    ap.add_argument("--link-gbs", type=float, default=None,
                    help="a link's bandwidth in GB/s, for the projection")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg, D = bign_config(args.nexp), args.ranks
    print(f"# j-major window sharding: n=2^{args.nexp} c={cfg.c} h={cfg.h} "
          f"|B|={cfg.b_size} D={D} (h padded to {-(-cfg.h // D) * D}); "
          f"device {profiling.device_name(device)}, "
          f"{group_backend(device.type, D)} group")
    t0 = time.perf_counter()
    per_rank = run_ranks(_rank, D, device, (args.nexp, args.reps,
                                            args.skip_2d))
    print(f"every rank bit-exact against the oracle; "
          f"{time.perf_counter() - t0:.1f} s with the spawn and builds")
    for rank, r in enumerate(per_rank):
        w = r["windows"]
        line = (f"rank {rank}: build {r['build_s']:.3f} s, {r['rows']} rows "
                f"held; query {w['total_ms']:.3f} ms (local "
                f"{w['local_ms']:.3f}, all-reduce {w['allreduce_ms']:.3f} = "
                f"exchange {w['exchange_ms']:.3f} + dadd {w['dadd_ms']:.3f} "
                f"over {w['rounds']} rounds, integration "
                f"{w['integrate_ms']:.3f})")
        if "mesh2d" in r:
            line += f"; 2-D mesh query {r['mesh2d']['total_ms']:.3f} ms"
        print(line)
    dadd_ms = per_rank[0]["dadd_bucket_ms"]
    rate = cfg.b_size / (dadd_ms / 1e3)
    print(f"dadd at the bucket width: {dadd_ms:.4f} ms, {rate:.4g}/s")
    record = {"driver": "sharded_bign", "nexp": args.nexp, "ranks": D,
              "b_size": cfg.b_size, "device": profiling.device_name(device),
              "dadd_per_s": rate, "per_rank": per_rank}
    if args.link_gbs:
        proj = project(cfg.b_size, rate, args.link_gbs)
        for Dp, t in proj.items():
            print(f"projected all-reduce at {args.link_gbs:g} GB/s a link: "
                  f"D={Dp} {t:.3f} ms")
        record["projected"] = {str(Dp): t for Dp, t in proj.items()}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

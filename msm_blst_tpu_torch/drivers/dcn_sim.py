"""Two processes meeting over TCP run the points-sharded CHES query (port of
drivers/dcn_sim.py).

The reference has no cross-host story (its only parallelism is the Rust
thread-pool tile grid, bindings/rust/src/lib.rs:1804-1949). This driver
shows the port's sharded query across a process boundary over the network
stack, the path a multi-host deployment takes: two spawned ranks of a
process group (gloo, or NCCL where each has a card of its own) that meet at 127.0.0.1 on a free port picked at launch (env://).
Each builds the plan, keeps its own points' shard and runs the query; each
result must equal the oracle (sum_i s_i 2^(i+1) mod r) * G. A rank that
fails, or a peer that hangs past --timeout, fails the run (the other rank
is killed).

--radix 8: make_config(6, c=8, h=32); 16: CONFIGS[14]'s radix (c = 16,
h = 16; the all-reduce over 18,343 buckets).

Run:

    python -m msm_blst_tpu_torch.drivers.dcn_sim [--radix 8|16]
        [--timeout 900] [--device cpu]
"""

from __future__ import annotations

import argparse
import socket

from ..curves import G1
from ..device import resolve
from ..msm import build_plan, fixed_point_list, params, recode
from ..parallel import (make_points_mesh, shard_plan_tables,
                        sharded_msm_ches)
from ..parallel.ranks import run_ranks
from .run_msm import oracle_point

N = 64
RANKS = 2
SEED = 77


def config(radix: int) -> params.MsmConfig:
    if radix == 16:
        return params.make_config(6, c=16, h=16, ah=29677)
    return params.make_config(6, c=8, h=32, c_bgmw=8, h_bgmw=32)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, dev, radix: int) -> str:
    mesh = make_points_mesh(world, dev.type)
    plan = shard_plan_tables(build_plan(
        G1, fixed_point_list(G1, N, device=dev), config(radix), bgmw=False,
        stock=False), mesh)
    sc_np = recode.random_scalars(N, SEED)
    jac = sharded_msm_ches(plan, mesh)(recode.to_device(sc_np, dev))
    if G1.affine_to_ints(G1.jac_to_affine(jac))[0] != oracle_point(G1, sc_np):
        raise AssertionError(f"rank {rank}: mismatch against the oracle")
    return (f"rank {rank}: {world}-process sharded CHES MSM over TCP "
            f"bit-exact ({plan.table3nh.XY.shape[0]} rows held)")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--radix", type=int, default=8, choices=(8, 16))
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before a hung rank fails the run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    port = free_port()
    lines = run_ranks(_rank, RANKS, resolve(args.device), (args.radix,),
                      init_method="env://",
                      env={"MASTER_ADDR": "127.0.0.1",
                           "MASTER_PORT": str(port)},
                      timeout_s=args.timeout)
    for line in lines:
        print(line)
    print(f"dcn_sim: OK (127.0.0.1:{port}, radix {args.radix})")
    return lines


if __name__ == "__main__":
    main()

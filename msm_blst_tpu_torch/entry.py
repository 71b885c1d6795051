"""The flagship query as a callable (the counterpart of the JAX package's
__graft_entry__.entry).

entry(device=None) -> (fn, example_args): fn(*example_args) runs the G1
CHES "nh + 0.21q" query (device-side integral scalar conversion -> sort ->
prefix-level bucket accumulation -> d-gap integration) on a 64-point plan
with make_config(6, c=8, h=32, c_bgmw=8, h_bgmw=32) and returns a Jacobian
batch of 1. The example scalars are recode.random_scalars(64, seed=7), the
JAX entry's. The device defaults to the card.

dryrun_multichip(n_devices, device=None) -> the sharded dry run (the
counterpart of __graft_entry__.dryrun_multichip): n_devices spawned ranks
of a process group run the points-sharded CHES query at 8 * n_devices points
and the window-sharded CHES query of a "j"-layout plan with h = 33 (h
padded to the next multiple of the ranks), each checked against the
oracle on every rank. On CUDA rank r runs on card r mod the card count;
the group is NCCL where every rank has a card of its own, else gloo,
whose all-reduce exchanges go through pinned host memory.
"""

from __future__ import annotations

from .constants import R_ORDER
from .curves import G1
from .device import resolve
from .msm import build_plan, fixed_point_list, msm_ches_device, params, recode
from .refimpl import G1 as G1_ORACLE


def _small_setup(n_points: int, device):
    cfg = params.make_config(max(n_points.bit_length() - 1, 1), c=8, h=32,
                             c_bgmw=8, h_bgmw=32)
    points = fixed_point_list(G1, n_points, device=device)
    plan = build_plan(G1, points, cfg, bgmw=False, stock=False)
    scalars = recode.to_device(recode.random_scalars(n_points, seed=7), device)
    return plan, scalars


def entry(device=None):
    """Returns (fn, example_args): the G1 CHES query on a 64-point plan
    and its example scalars, on `device` (default: the card)."""
    plan, scalars = _small_setup(64, resolve(device))

    def fn(scalars):
        return msm_ches_device(plan, scalars)

    return fn, (scalars,)


def _dryrun_rank(rank: int, world: int, dev) -> None:
    """One rank of dryrun_multichip: both sharded queries against the
    oracle (sum_i s_i 2^(i+1) mod r) * G."""
    from .parallel import (make_points_mesh, make_windows_mesh,
                           shard_plan_tables, shard_plan_tables_jmajor,
                           sharded_msm_ches, sharded_msm_ches_windows)

    n = 8 * world
    log_n = max(n.bit_length() - 1, 1)
    points = fixed_point_list(G1, n, device=dev)
    scalars_np = recode.random_scalars(n, seed=9)
    scalars = recode.to_device(scalars_np, dev)
    ints = recode.scalars_to_ints(scalars_np)
    want = G1_ORACLE.mult(sum(s * pow(2, i + 1, R_ORDER)
                              for i, s in enumerate(ints)) % R_ORDER)
    cfg = params.make_config(log_n, c=8, h=32, c_bgmw=8, h_bgmw=32)
    mesh = make_points_mesh(world, dev.type)
    plan = shard_plan_tables(build_plan(G1, points, cfg, bgmw=False,
                                        stock=False), mesh)
    got = G1.affine_to_ints(G1.jac_to_affine(
        sharded_msm_ches(plan, mesh)(scalars)))[0]
    if got != want:
        raise AssertionError(f"rank {rank}: sharded MSM {got} differs from "
                             f"the oracle {want}")
    # a "j"-layout plan, sharded by windows; h = 33 pads to the ranks
    cfg_j = params.make_config(log_n, c=8, h=33, c_bgmw=8, h_bgmw=33)
    mesh_w = make_windows_mesh(world, dev.type)
    plan_j = build_plan(G1, points, cfg_j, bgmw=False, stock=False,
                        streamed=True)
    plan_j = shard_plan_tables_jmajor(plan_j, mesh_w)
    got = G1.affine_to_ints(G1.jac_to_affine(
        sharded_msm_ches_windows(plan_j, mesh_w)(scalars)))[0]
    if got != want:
        raise AssertionError(f"rank {rank}: window-sharded MSM {got} differs "
                             f"from the oracle {want}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Runs the sharded CHES queries (points axis; windows of a "j" plan)
    on n_devices spawned ranks on `device` (default: the card; parallel.
    run_ranks places them and picks the group's backend), each against the oracle on every rank; raises if a rank fails,
    hangs or differs."""
    from .parallel import run_ranks

    run_ranks(_dryrun_rank, n_devices, resolve(device))

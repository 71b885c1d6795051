"""One process a rank: spawned workers joined by a torch.distributed process
group, for the sharded paths (parallel/sharded.py) and their callers.

`run_ranks(fn, world_size, device, args)` starts `world_size` processes
with the spawn start method (a parent that already holds a CUDA context
cannot fork one), each of which takes its device, joins the group and
calls `fn(rank, world_size, its device, *args)`; the parent gathers each
rank's return value. A rank that raises, dies or outlasts the timeout
fails the run, and every rank still running is killed. On CUDA, rank r
runs on card r mod the card count; the group is NCCL when every rank has
a card of its own and gloo otherwise (`group_backend`). `in_turns` runs a
build on one rank after another. `fn`, `args` and the results are
pickled: `fn` must be a module-level function.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_S = 60.0  # how long a rank that has sent its result may take to exit
DRAIN_S = 5.0  # how long a failed run waits for the other ranks' errors


def group_backend(device_type: str, world_size: int) -> str:
    """The group's backend for `world_size` ranks on `device_type`: NCCL
    when each rank has a card of its own, gloo on the CPU and where ranks
    share a card (NCCL refuses two ranks on one device; on gloo,
    ec_allreduce_xyzz stages the exchanges through host memory)."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _place(device_type: str, rank: int) -> torch.device:
    """Rank `rank`'s device: on CUDA, card rank mod the card count, made
    current (NCCL's collectives use the current card); else the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _rank_main(fn, rank: int, world_size: int, device_type: str,
               init_method: str, env: dict, timeout_s: float, results,
               args) -> None:
    """A spawned rank: set `env`, take its device, join the group, run fn,
    send (rank, error, result) back; an error's traceback goes back as
    text and the rank exits non-zero."""
    try:
        os.environ.update(env)
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dev = _place(device_type, rank)
        dist.init_process_group(
            group_backend(device_type, world_size), init_method=init_method,
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, dev, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    results.put((rank, None, out))


def run_ranks(fn, world_size: int, device, args=(),
              init_method: str | None = None, env: dict | None = None,
              timeout_s: float = 600.0):
    """[fn(0, world_size, dev_0, *args), ..., fn(world_size - 1, ...)],
    each computed in its own spawned process, the ranks of one process
    group. `device` (a torch.device or its string) names the device type:
    dev_r is the CPU, or card r mod the card count (_place); the group's
    backend is group_backend's. `init_method`: the group's rendezvous
    (default: a FileStore in a temporary directory; "env://" reads
    MASTER_ADDR and MASTER_PORT, which `env`, variables set in each rank
    before it joins, can give).
    Raises RuntimeError when a rank raises or exits without a result, or
    when the ranks have not all finished within `timeout_s` seconds (the
    group's own timeout too); every rank still running is killed first."""
    ctx = mp.get_context("spawn")
    device_type = torch.device(device).type
    with tempfile.TemporaryDirectory() as tmp:
        init = init_method or f"file://{tmp}/store"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, name=f"rank {rank}",
                             args=(fn, rank, world_size, device_type, init,
                                   dict(env or {}), timeout_s, results,
                                   tuple(args)))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        try:
            got = _gather(procs, results, time.monotonic() + timeout_s)
            for p in procs:
                p.join(JOIN_S)
            codes = [p.exitcode for p in procs]
            if any(code != 0 for code in codes):
                raise RuntimeError(f"run_ranks: exit codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[rank] for rank in range(world_size)]


def _gather(procs, results, deadline: float) -> dict:
    """Each rank's result, by rank, read from `results` until every rank
    has sent one; raises on a rank's error, on a rank that exited without a
    result, and at `deadline`."""
    got = {}
    while len(got) < len(procs):
        try:
            rank, err, out = results.get(timeout=1.0)
        except queue.Empty:
            gone = [r for r, p in enumerate(procs)
                    if p.exitcode is not None and r not in got]
            if gone:  # one more read: a result may still be in flight
                try:
                    rank, err, out = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"run_ranks: ranks {gone} exited (codes "
                        f"{[procs[r].exitcode for r in gone]}) without a "
                        "result") from None
            elif time.monotonic() > deadline:
                missing = sorted(set(range(len(procs))) - set(got))
                raise RuntimeError(f"run_ranks: ranks {missing} did not "
                                   "finish in time") from None
            else:
                continue
        if err is not None:
            raise RuntimeError(_failures(results, {rank: err}))
        got[rank] = out
    return got


def _failures(results, errors: dict) -> str:
    """The message of a failed run: every rank's traceback that arrives
    within DRAIN_S of the first, since a rank's failure often makes its
    peers fail too, and the first to arrive need not be the cause."""
    deadline = time.monotonic() + DRAIN_S
    while (left := deadline - time.monotonic()) > 0:
        try:
            rank, err, _ = results.get(timeout=left)
        except queue.Empty:
            break
        if err is not None:
            errors[rank] = err
    return "run_ranks: " + "\n".join(
        f"rank {rank} failed:\n{err}" for rank, err in sorted(errors.items()))


def in_turns(rank: int, world_size: int, device: torch.device, build):
    """build() on each rank of the default group in turn, rank 0 first,
    with a barrier after each (and the card's cache emptied), so that no
    two ranks build at once: ranks sharing a card see each other's memory
    in its free bytes (device.budget_bytes). Returns this rank's build()."""
    out = None
    for turn in range(world_size):
        if turn == rank:
            out = build()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        dist.barrier()
    return out


"""The sharding drivers' transport on the CPU and the rank spawner.

* drivers/dcn_sim.py at radix 8: two spawned ranks meet over TCP at
  127.0.0.1 on a free port (env://), each builds the plan and keeps its
  shard, and each result equals the oracle.
* parallel.run_ranks returns each rank's result, each rank on its device;
  a rank that raises fails the run with its traceback, and one that hangs
  is killed at the timeout.
* ranks.group_backend: NCCL only where every rank has a card of its own.
"""

from __future__ import annotations

import time

import pytest

from msm_blst_tpu_torch.drivers import dcn_sim
from msm_blst_tpu_torch.parallel import ranks, run_ranks


def test_dcn_sim_radix_8():
    lines = dcn_sim.main(["--radix", "8", "--device", "cpu",
                          "--timeout", "300"])
    assert len(lines) == dcn_sim.RANKS
    assert all("bit-exact" in line for line in lines)


def _fails_on_rank_1(rank: int, world: int, dev) -> int:
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def _hangs_on_rank_0(rank: int, world: int, dev) -> int:
    if rank == 0:
        time.sleep(3600)
    return rank


def _returns_rank(rank: int, world: int, dev, scale: int) -> tuple:
    return scale * rank + world, str(dev)


def test_run_ranks_returns_each_ranks_result():
    assert run_ranks(_returns_rank, 3, "cpu", (10,)) == [
        (3, "cpu"), (13, "cpu"), (23, "cpu")]


def test_run_ranks_fails_when_a_rank_raises():
    with pytest.raises(RuntimeError,
                       match="(?s)rank 1 failed:.*ValueError: rank 1 fails"):
        run_ranks(_fails_on_rank_1, 2, "cpu", timeout_s=60)


def test_run_ranks_kills_a_hung_rank():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish in time"):
        run_ranks(_hangs_on_rank_0, 2, "cpu", timeout_s=5)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("device_type, world, cards, backend", [
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 4, "gloo"),
    ("cuda", 1, 1, "nccl"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 4, "nccl"),
    ("cuda", 4, 1, "gloo"), ("cuda", 8, 4, "gloo")])
def test_group_backend_is_nccl_only_on_distinct_cards(
        monkeypatch, device_type, world, cards, backend):
    monkeypatch.setattr(ranks.torch.cuda, "device_count", lambda: cards)
    assert ranks.group_backend(device_type, world) == backend

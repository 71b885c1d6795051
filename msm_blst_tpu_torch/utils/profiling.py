"""Profiling and observability for the port (port of
msm_blst_tpu/utils/profiling.py).

* `span(name)`: a wall-clock span that waits for the card
  (`torch.cuda.synchronize()`) when it opens and when it closes.
* `trace(path)`: a `torch.profiler` trace around a block, written as a
  Chrome trace (chrome://tracing, Perfetto).
* `device_ms(fn)`: a call's mean time, by CUDA events on the card around
  back-to-back calls (the host's launch work counts where it is the
  slower);
  `graph_ms(fn)` the same over a CUDA graph of the calls, without it.
* The op-count models per algorithm and `report(...)`, which turns a
  measured wall time into Fp multiplies a second and, given the device's
  measured multiply rate (drivers/microbench.py `fp_mont_mul_per_s`), the
  fraction of it achieved. The models and the record's fields are the JAX
  package's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, results: Optional[dict] = None, verbose: bool = True):
    """Wall-clock span, in seconds into `results[name]`; the card's queued
    work is finished on entry and counted on exit."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    if verbose:
        print(f"[span] {name}: {dt*1e3:.1f} ms")


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block (CPU, and CUDA when there is a
    card), written to `logdir`/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_ms(fn, reps: int = 10, warmup: int = 1) -> float:
    """Mean milliseconds per call of `fn` over `reps` calls after `warmup`,
    by CUDA events (the card's own clock)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean milliseconds per call of `fn` on the card without the host's
    launch work: `calls` calls captured in one CUDA graph (after one warm-up
    call), replayed `replays` times between CUDA events (one replay first,
    untimed). The gaps between the graph's kernels count."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(fn, reps: int = 10, warmup: int = 1) -> float:
    """The same on the host's clock, for a run on the CPU."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, device, reps: int = 10, warmup: int = 1) -> float:
    """device_ms for a CUDA device, host_ms for the CPU."""
    timer = device_ms if torch.device(device).type == "cuda" else host_ms
    return timer(fn, reps, warmup)


def sync(device) -> None:
    """Wait for `device`'s queued work (torch.cuda.synchronize on the
    card; nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    """The card's name (torch.cuda.get_device_name), or "cpu"."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


# ---------------------------------------------------------------------------
# op-count models (from the reference's tile implementations; BASELINE.md)
# ---------------------------------------------------------------------------

# Fp-muls per curve op (M+S counted as muls; G2 ~3x via Karatsuba)
DADD_AFFINE = 10  # 8M + 2S
DADD = 14         # 12M + 2S
DOUBLE = 7        # 2M + 5S (Jacobian)


@dataclass
class OpCounts:
    accum_adds: int      # dadd_affine count (the n*h stream)
    integ_adds: int      # dadd count in integration
    doublings: int

    @property
    def fp_muls(self) -> int:
        return (self.accum_adds * DADD_AFFINE + self.integ_adds * DADD
                + self.doublings * DOUBLE)


def ches_op_counts(n: int, cfg) -> OpCounts:
    """CHES query model: n*h accumulates + (2 B_SIZE + 2 d_max) integration
    adds, zero doublings (multi_scalar.c:421-463, :301-321)."""
    return OpCounts(n * cfg.h, 2 * cfg.b_size + 2 * cfg.d_max, 0)


def bgmw_op_counts(n: int, cfg) -> OpCounts:
    return OpCounts(n * cfg.h_bgmw, 2 * ((cfg.q_bgmw >> 1) + 1), 0)


def stock_op_counts(n: int, window: int) -> OpCounts:
    h = -(-255 // window)
    return OpCounts(n * h, h * (1 << (window - 1)) * 2, 255)


def report(metric: str, wall_s: float, ops: OpCounts,
           device_muls_per_s: Optional[float] = None, g2: bool = False) -> dict:
    """One observability record: wall-clock, modeled Fp-muls, achieved rate,
    and (if the device's measured multiply throughput is supplied) the
    fraction of multiply-roofline achieved."""
    muls = ops.fp_muls * (3 if g2 else 1)
    rec = {
        "metric": metric,
        "wall_ms": round(wall_s * 1e3, 2),
        "model_fp_muls": muls,
        "achieved_fp_muls_per_s": float(f"{muls / wall_s:.4g}"),
    }
    if device_muls_per_s:
        rec["fraction_of_mul_roofline"] = round(
            muls / wall_s / device_muls_per_s, 3
        )
    return rec


def print_report(*args, **kwargs) -> dict:
    rec = report(*args, **kwargs)
    print(json.dumps(rec))
    return rec

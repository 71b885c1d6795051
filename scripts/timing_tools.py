"""What the timing scripts share: the card's name and power limit, the
checkout to time (`--tree`), this checkout's timers, and the profiler's
device time of a call's kernels. The scripts run as
`python3 scripts/<name>.py` from the repository root, which puts this
folder on the import path.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def use_tree(tree: str = ROOT) -> str:
    """Put the checkout at `tree` first on the import path, so that
    `msm_blst_tpu_torch` is its package; returns its absolute path."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    return tree


def own_timers():
    """This checkout's utils/profiling.py, loaded from its file, so that
    every tree is timed by the same timers (it imports only torch)."""
    path = os.path.join(ROOT, "msm_blst_tpu_torch", "utils", "profiling.py")
    spec = importlib.util.spec_from_file_location("_own_timers", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def device_us(evt) -> float:
    """A profiler event's own device time (µs), by either name torch gives it."""
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def kernel_ms(fn, calls: int = 20) -> tuple:
    """torch.profiler's device time of the kernels of `calls` calls of
    `fn` (after one warm-up), over `calls` (ms), and the kernels by name
    with their launches."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    total = sum(device_us(e) for e in evts) / 1e3 / calls
    return total, [{"kernel": e.key[:80], "count": e.count,
                    "us_per_call": device_us(e) / calls} for e in evts]


def host_us(fn, calls: int = 200) -> float:
    """Mean µs the host takes to issue a call of `fn`, over `calls` calls
    issued back to back without waiting (the card's queue drained before
    and after, untimed): the launch path alone where the card runs each
    call faster than the host issues it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / calls

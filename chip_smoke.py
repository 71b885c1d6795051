"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit (nvidia-smi), torch, CUDA and
     nvcc versions; stops unless torch sees a CUDA device;
  2. build: compiles msm_blst_tpu_torch/csrc/*.cu and reports the time;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, exact equality, with CUDA-event times of both;
  4. main path: the G1 CHES n=2^16 query (params.CONFIGS[16]) — fixed
     points, the plan, one warm-up and five timed scalar sets — with every
     result checked against the pure-Python oracle and every kernel's
     launch count above zero;
  5. a JSON line of per-kernel results, then the final status line.

It catches no exception: any failure exits non-zero before the last line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_LOG = 16
WARM_SEED = 1
SEEDS = (2, 3, 4, 5, 6)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
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


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    from msm_blst_tpu_torch import kernels

    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"nvcc: {nvcc[-1]}")


def phase_build():
    from msm_blst_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({kernels.library_path().name})")


def _random_fp(n: int, seed: int, dev) -> torch.Tensor:
    """n canonical Fp word vectors (top word below p's), with 0, 1 and p-1
    in the first three lanes."""
    from msm_blst_tpu_torch.constants import P
    from msm_blst_tpu_torch.fields.limb import ints_to_array

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=(12, n), dtype=np.uint64)
    w[11] %= P >> 352
    w[:, :3] = ints_to_array([0, 1, P - 1], 12).view(np.uint32)
    return torch.as_tensor(w.astype(np.uint32).view(np.int32), device=dev)


def phase_kernels(dev):
    from msm_blst_tpu_torch.curves import G1, XyzzPoint
    from msm_blst_tpu_torch.curves import cuda_point
    from msm_blst_tpu_torch.fields import cuda_mont
    from msm_blst_tpu_torch.fields.limb import FP
    from msm_blst_tpu_torch.msm import cuda_scan, fixed_point_list

    results = {}

    def record(name, kernel_fn, plain_fn, reps, plain_reps):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        ms = cuda_ms(kernel_fn, reps)
        plain_ms = cuda_ms(plain_fn, plain_reps)
        print(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version differ")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # K1 on 2^20 elements
    a = _random_fp(1 << 20, 11, dev)
    b = _random_fp(1 << 20, 12, dev).flip(1).contiguous()
    record("mont_mul", lambda: cuda_mont.mont_mul(a, b, FP),
           lambda: cuda_mont.mont_mul_plain(a, b, FP), 20, 2)

    # K2 on 2^16 lanes: lane 0 infinity, lane 1 P+P, lane 2 P-P
    B = 1 << 16
    pts = fixed_point_list(G1, B, device=dev)
    lane = torch.arange(B, device=dev)
    base = G1.xyzz_from_affine(pts)
    acc = G1.xyzz_double(base)
    acc = G1.select(lane == 0, G1.xyzz_inf((B,), dev), acc)
    acc = G1.select((lane == 1) | (lane == 2), base, acc)
    signs = (lane % 3 == 2)
    other = G1.xyzz_from_affine(pts, negate=signs)
    record("point_dadd_affine",
           lambda: tuple(cuda_point.xyzz_dadd_affine(G1, acc, pts, signs)),
           lambda: tuple(cuda_point.xyzz_dadd_affine_plain(G1, acc, pts, signs)),
           20, 2)
    record("point_dadd",
           lambda: tuple(cuda_point.xyzz_dadd(G1, acc, other)),
           lambda: tuple(cuda_point.xyzz_dadd_plain(G1, acc, other)), 20, 2)
    record("point_double",
           lambda: tuple(cuda_point.xyzz_double(G1, acc)),
           lambda: tuple(cuda_point.xyzz_double_plain(G1, acc)), 20, 2)

    # K3 at the main path's level shape (c=112, n_ch=8192)
    c, n_ch = 112, 8192
    rng = np.random.default_rng(13)
    rows = G1.to_rows32(pts).XY
    slots = torch.as_tensor(rng.integers(0, B, size=c * n_ch), device=dev)
    slots[torch.arange(4, device=dev) * n_ch] = 7  # lane 0: P, 2P, P, inf
    g = rows.index_select(0, slots)
    rx = g[:, :12].reshape(c, n_ch, 12).contiguous()
    ry = g[:, 12:].reshape(c, n_ch, 12).contiguous()
    sg = torch.as_tensor(rng.integers(0, 2, size=(c, n_ch)), device=dev)
    sg[:2, 0] = 0
    sg[2:4, 0] = 1

    def k3():
        local, t = cuda_scan.affine_prefix_level(G1, rx, ry, sg)
        return (local,) + tuple(t)

    def k3_plain():
        local, t = cuda_scan.affine_prefix_level_plain(G1, rx, ry, sg)
        return (local,) + tuple(t)

    record("affine_prefix_level", k3, k3_plain, 5, 1)

    # K4 at the integration suffix scan's level shape (c=54, n_ch=2048)
    c4, n4 = cuda_scan._shape_stream(109243)
    local = k3()[0].reshape(-1, 4, 12)[: c4 * n4]
    cols = XyzzPoint(*(local[:, i].reshape(c4, n4, 12).permute(0, 2, 1)
                       .contiguous() for i in range(4)))

    def k4():
        s, t = cuda_scan.xyzz_scan_level(G1, cols)
        return tuple(s) + tuple(t)

    def k4_plain():
        s, t = cuda_scan.xyzz_scan_level_plain(G1, cols)
        return tuple(s) + tuple(t)

    record("xyzz_scan_level", k4, k4_plain, 5, 1)
    return results


def phase_main_path(dev):
    from msm_blst_tpu_torch import refimpl as ref
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.curves import G1, cuda_point
    from msm_blst_tpu_torch.fields import cuda_mont
    from msm_blst_tpu_torch.msm import (build_plan, cuda_scan,
                                        fixed_point_list, msm_ches_device,
                                        params, recode)

    counters = {
        "mont_mul": cuda_mont.MONT_MUL,
        "point_dadd_affine": cuda_point.DADD_AFFINE,
        "point_dadd": cuda_point.DADD,
        "point_double": cuda_point.DOUBLE,
        "affine_prefix_level": cuda_scan.AFFINE_PREFIX,
        "xyzz_scan_level": cuda_scan.XYZZ_SCAN,
    }
    n = 1 << N_LOG
    cfg = params.CONFIGS[N_LOG]
    weights = [pow(2, i + 1, R_ORDER) for i in range(n)]

    def check(seed, jac):
        ints = recode.scalars_to_ints(recode.random_scalars(n, seed))
        total = sum(s * e for s, e in zip(ints, weights)) % R_ORDER
        got = G1.affine_to_ints(G1.jac_to_affine(jac))[0]
        if got != ref.mult(total):
            raise AssertionError(f"seed {seed}: MSM differs from the oracle")

    scalars = {s: recode.to_device(recode.random_scalars(n, s), dev)
               for s in (WARM_SEED,) + SEEDS}
    torch.cuda.synchronize()
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    points = fixed_point_list(G1, n, device=dev)
    plan = build_plan(G1, points, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"main path: n=2^{N_LOG}, c={cfg.c}, h={cfg.h}, |B|={cfg.b_size}, "
          f"table {tuple(plan.table3nh.XY.shape)}; fixed points + plan "
          f"{build_s:.3f} s")
    check(WARM_SEED, msm_ches_device(plan, scalars[WARM_SEED]))
    times = []
    for s in SEEDS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        jac = msm_ches_device(plan, scalars[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        check(s, jac)
    launches = {name: k.launches for name, k in counters.items()}
    print(f"main path: {len(SEEDS)} queries equal to the oracle; query mean "
          f"{1e3 * sum(times) / len(times):.3f} ms, min {1e3 * min(times):.3f}"
          f" ms; launches {launches}")
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"main path never launched: {idle}")
    return launches


SOURCES = {
    "mont_mul": ("msm_blst_tpu_torch/csrc/mont_mul.cu",
                 "msm_blst_tpu/fields/pallas_mont.py:281"),
    "point_dadd_affine": ("msm_blst_tpu_torch/csrc/point_ops.cu",
                          "msm_blst_tpu/curves/pallas_point.py:49"),
    "point_dadd": ("msm_blst_tpu_torch/csrc/point_ops.cu",
                   "msm_blst_tpu/curves/pallas_point.py:49"),
    "point_double": ("msm_blst_tpu_torch/csrc/point_ops.cu",
                     "msm_blst_tpu/curves/pallas_point.py:49"),
    "affine_prefix_level": ("msm_blst_tpu_torch/csrc/scan.cu",
                            "msm_blst_tpu/msm/pallas_scan.py:463"),
    "xyzz_scan_level": ("msm_blst_tpu_torch/csrc/scan.cu",
                        "msm_blst_tpu/msm/pallas_scan.py:367"),
}


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    results = phase_kernels(dev)
    launches = phase_main_path(dev)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

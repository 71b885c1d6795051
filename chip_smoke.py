"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit (nvidia-smi), its top SM
     clock, torch, CUDA and nvcc versions; stops unless torch sees a CUDA
     device;
  2. build: compiles msm_blst_tpu_torch/csrc/*.cu (one nvcc per source, in
     parallel) and reports the time and each kernel's registers and spills;
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card, exact equality, with CUDA-event times of both and the least time
     the card could take for the same work (bytes or integer multiply-adds);
  4. main path: the G1 CHES n=2^16 query (params.CONFIGS[16]) — fixed
     points, the plan, one warm-up and five timed scalar sets — with every
     result checked against the pure-Python oracle and every kernel of the
     path launched;
  5. algorithms: one plan with the CHES, BGMW95 and stock tables at the same
     n and config; host-recode CHES, BGMW95 and stock Pippenger, BGMW and
     stock with both bucket strategies (prefix, segmented), each query
     checked against the oracle; the plan build and each path count their
     launches on their own: every kernel of the path (K5's two variants on
     the segmented ones) launched, none of the other strategy's;
  6. a JSON line of per-kernel results, then the final status line.

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
ALGO_SEEDS = (7, 8, 9)  # timed scalar sets of phase 5 (stock: the first two)

# The least time the card could take (the bound): the larger of the bytes a
# kernel must move over the memory rate, and its integer multiply-adds over
# the SMs' rate. H100 SXM: 3.35 TB/s; 132 SMs, each 64 32-bit integer
# multiply-adds per clock, at the top SM clock nvidia-smi reports.
HBM_BYTES_PER_S = 3.35e12
SMS, IMAD_PER_CLOCK = 132, 64
# A 12-word CIOS Montgomery product (csrc/fp.cuh mont_mul): 288 word
# products with 64-bit results (two multiply-adds each) and 12 low halves.
IMAD_PER_MONT = 2 * 288 + 12
# Montgomery products of the point formulas (csrc/fp.cuh), without their
# doubling branch (taken by the few lanes that add a point to itself).
MONT_DADD_AFFINE, MONT_DADD, MONT_DOUBLE = 10, 14, 9
FP_BYTES = 48


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


def top_sm_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])


def imad_per_s() -> float:
    return SMS * IMAD_PER_CLOCK * top_sm_mhz() * 1e6


def bound(n_bytes: float, n_mont: float) -> dict:
    """The larger of the two least times, in ms, and which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_mont * IMAD_PER_MONT / imad_per_s() * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    print(f"top SM clock: {top_sm_mhz():g} MHz")
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
    for name, regs in sorted(kernels.ptxas_summary().items()):
        print(f"ptxas {name}: {regs}")


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

    def record(name, kernel_fn, plain_fn, reps, plain_reps, n_bytes, n_mont):
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        ms = cuda_ms(kernel_fn, reps)
        plain_ms = cuda_ms(plain_fn, plain_reps)
        b = bound(n_bytes, n_mont)
        print(f"kernel {name}: max_abs_err {err}, {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain version differ")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **b, "library_ms": None}

    # K1 on 2^20 elements
    a = _random_fp(1 << 20, 11, dev)
    b = _random_fp(1 << 20, 12, dev).flip(1).contiguous()
    record("mont_mul", lambda: cuda_mont.mont_mul(a, b, FP),
           lambda: cuda_mont.mont_mul_plain(a, b, FP), 20, 2,
           3 * FP_BYTES * a.shape[1], a.shape[1])

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
           20, 2, (10 * FP_BYTES + 4) * B, MONT_DADD_AFFINE * B)
    record("point_dadd",
           lambda: tuple(cuda_point.xyzz_dadd(G1, acc, other)),
           lambda: tuple(cuda_point.xyzz_dadd_plain(G1, acc, other)), 20, 2,
           12 * FP_BYTES * B, MONT_DADD * B)
    record("point_double",
           lambda: tuple(cuda_point.xyzz_double(G1, acc)),
           lambda: tuple(cuda_point.xyzz_double_plain(G1, acc)), 20, 2,
           8 * FP_BYTES * B, MONT_DOUBLE * B)

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

    record("affine_prefix_level", k3, k3_plain, 5, 1,
           c * n_ch * (6 * FP_BYTES + 4) + 4 * FP_BYTES * n_ch,
           MONT_DADD_AFFINE * (c - 1) * n_ch)

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

    record("xyzz_scan_level", k4, k4_plain, 5, 1,
           c4 * n4 * 8 * FP_BYTES + 4 * FP_BYTES * n4,
           MONT_DADD * (c4 - 1) * n4)

    # K5 at BGMW's first two levels: (60, 16384) and (32, 1024)
    phase_seg_kernels(dev, record, rows, rng)
    return results


def seg_work(keys, n_buckets: int, in_bytes: int, mont_add: int):
    """(bytes, Montgomery products) of one K5 level on these keys: every
    element read once; each lane writes head, tail and two keys; every
    complete run one bucket; a column that keeps its run adds a point."""
    c, n_ch = keys.shape
    closing = keys[1:] != keys[:-1]
    lanes_closing = int(closing.any(dim=0).sum())
    emissions = int(closing.sum()) - lanes_closing
    n_bytes = (c * n_ch * (in_bytes + 4) + n_ch * (8 * FP_BYTES + 8)
               + 4 * FP_BYTES * emissions)
    return n_bytes, mont_add * int((~closing).sum())


def seg_stream(rng, n_rows: int, N: int, c: int, n_buckets: int):
    """A key-sorted signed digit stream (slots, keys, signs as numpy) over
    n_buckets with about N / n_buckets elements per key, as BGMW's. One
    point repeats four times inside a run (a doubling) with a sign
    cancellation. At the boundaries of lanes 100 and 300 (c columns each) a
    key of its own holds one point four times, two in each lane: lane k's
    tail and lane k+1's head are 2P and 2P (lane 100) or 2P and -2P (lane
    300), which the next level adds: a doubling and a cancellation there.
    Returns the stream and those two pairs' positions in the next level's
    stream of interleaved heads and tails."""
    slots = rng.integers(0, n_rows, N)
    keys = np.sort(rng.integers(0, n_buckets, N))
    signs = rng.integers(0, 2, N)
    slots[10:14] = slots[10]
    keys[10:14] = keys[10]
    signs[12] = 1 - signs[11]
    meets = []
    for lane, flip in ((100, 0), (300, 1)):
        i = (lane + 1) * c
        v = keys[i]
        keys[:i - 2] = np.minimum(keys[:i - 2], v - 1)
        keys[i + 2:] = np.maximum(keys[i + 2:], v + 1)
        keys[i - 2:i + 2] = v
        slots[i - 2:i + 2] = slots[i]
        signs[i - 2:i + 2] = (0, 0, flip, flip)
        meets.append(2 * lane + 1)
    keys[-7:] = n_buckets  # pads
    return slots, keys.astype(np.int32), signs.astype(np.int32), meets


def phase_seg_kernels(dev, record, rows, rng):
    """K5 against its plain version at the first two levels of BGMW's path
    (n = 2^16, c' = 17, h' = 15: 983,040 digits over 2^16+1 buckets): the
    affine level (c=60, n_ch=16384) on real table rows (seg_stream), and
    the xyzz level (32, 1024) on that level's own heads and tails, shaped by
    the path's own code (cuda_scan.level_cols). The bucket arrays must agree
    too."""
    from msm_blst_tpu_torch.curves import G1, PackedRows32
    from msm_blst_tpu_torch.msm import cuda_scan

    n_buckets = (1 << 16) + 1
    slots, keys, signs, meets = seg_stream(rng, rows.shape[0], 60 * 16384,
                                           60, n_buckets)
    stream = PackedRows32(rows.index_select(0, torch.as_tensor(slots,
                                                               device=dev)))
    sg = torch.as_tensor(signs, device=dev)
    ky = torch.as_tensor(keys, device=dev)
    level1 = cuda_scan.level_cols(G1, stream, sg, ky, n_buckets)
    nxt, nkeys = cuda_scan._run_level(
        G1, stream, sg, ky, cuda_scan.bucket_array(G1, n_buckets, dev),
        n_buckets)
    for m in meets:  # the pair the xyzz level doubles or cancels
        if nkeys[m] != nkeys[m + 1] or not torch.equal(nxt.X[:, m],
                                                       nxt.X[:, m + 1]):
            raise AssertionError(f"seg_level_xyzz input: no meeting pair at {m}")
    level2 = cuda_scan.level_cols(G1, nxt, None, nkeys, n_buckets)
    for (_, _, kc), shape in ((level1, (60, 16384)), (level2, (32, 1024))):
        if tuple(kc.shape) != shape:
            raise AssertionError(f"K5 level shape {tuple(kc.shape)} != {shape}")

    def runs(cols, sg, kc, n_buckets, fn):
        # the emission stores are idempotent, so repeated calls may share
        # one bucket array
        buckets = cuda_scan.bucket_array(G1, n_buckets, dev)

        def go():
            head, tail, hk, tk = fn(G1, cols, sg, kc, buckets, n_buckets)
            return tuple(buckets) + tuple(head) + tuple(tail) + (hk, tk)
        return go

    for name, (cols, sg, kc), in_bytes, mont in (
            ("seg_level_affine", level1, 2 * FP_BYTES + 4, MONT_DADD_AFFINE),
            ("seg_level_xyzz", level2, 4 * FP_BYTES, MONT_DADD)):
        record(name, runs(cols, sg, kc, n_buckets, cuda_scan.seg_level),
               runs(cols, sg, kc, n_buckets, cuda_scan.seg_level_plain), 5, 1,
               *seg_work(kc, n_buckets, in_bytes, mont))


def counters():
    """Each kernel's launch counter, by the name the JSON line gives it."""
    from msm_blst_tpu_torch.curves import cuda_point
    from msm_blst_tpu_torch.fields import cuda_mont
    from msm_blst_tpu_torch.msm import cuda_scan

    return {
        "mont_mul": cuda_mont.MONT_MUL,
        "point_dadd_affine": cuda_point.DADD_AFFINE,
        "point_dadd": cuda_point.DADD,
        "point_double": cuda_point.DOUBLE,
        "affine_prefix_level": cuda_scan.AFFINE_PREFIX,
        "xyzz_scan_level": cuda_scan.XYZZ_SCAN,
        "seg_level_affine": cuda_scan.SEG_AFFINE,
        "seg_level_xyzz": cuda_scan.SEG_XYZZ,
    }


def reset_counts():
    torch.cuda.synchronize()
    for k in counters().values():
        k.launches = 0


def read_counts(path: str, names, unused=()) -> dict:
    """The path's launch counts; fails if one of its kernels (`names`) never
    ran, or if a kernel of the other bucket strategy (`unused`) did."""
    launches = {name: k.launches for name, k in counters().items()}
    print(f"{path}: launches {launches}")
    idle = [name for name in names if launches[name] == 0]
    if idle:
        raise AssertionError(f"{path} never launched: {idle}")
    stray = [name for name in unused if launches[name] != 0]
    if stray:
        raise AssertionError(f"{path} launched the other strategy's {stray}")
    return launches


# The kernels each query launches: the integration's folds, doublings and
# suffix scan and the conversion to Jacobian, then those of its bucket
# strategy.
QUERY_KERNELS = ["mont_mul", "point_dadd", "point_double", "xyzz_scan_level"]
STRATEGY_KERNELS = {"prefix": ["affine_prefix_level"],
                    "segmented": ["seg_level_affine", "seg_level_xyzz"]}


def oracle_check(n: int):
    """check(seed, jac): the query's result must be the oracle's
    (sum s_i 2^(i+1) mod r) * G for the scalars of `seed`."""
    from msm_blst_tpu_torch import refimpl as ref
    from msm_blst_tpu_torch.constants import R_ORDER
    from msm_blst_tpu_torch.curves import G1
    from msm_blst_tpu_torch.msm import recode

    weights = [pow(2, i + 1, R_ORDER) for i in range(n)]

    def check(seed, jac):
        ints = recode.scalars_to_ints(recode.random_scalars(n, seed))
        total = sum(s * e for s, e in zip(ints, weights)) % R_ORDER
        got = G1.affine_to_ints(G1.jac_to_affine(jac))[0]
        if got != ref.mult(total):
            raise AssertionError(f"seed {seed}: MSM differs from the oracle")
    return check


def phase_main_path(dev):
    from msm_blst_tpu_torch.curves import G1
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_ches_device, params, recode)

    n = 1 << N_LOG
    cfg = params.CONFIGS[N_LOG]
    check = oracle_check(n)
    scalars = {s: recode.to_device(recode.random_scalars(n, s), dev)
               for s in (WARM_SEED,) + SEEDS}
    reset_counts()
    t0 = time.perf_counter()
    points = fixed_point_list(G1, n, device=dev)
    plan = build_plan(G1, points, cfg, bgmw=False, stock=False)
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
    print(f"main path: {len(SEEDS)} queries equal to the oracle; query mean "
          f"{1e3 * sum(times) / len(times):.3f} ms, min {1e3 * min(times):.3f}"
          f" ms")
    return read_counts("main path", [
        "mont_mul", "point_dadd_affine", "point_dadd", "point_double",
        "affine_prefix_level", "xyzz_scan_level"],
        unused=STRATEGY_KERNELS["segmented"])


def phase_algorithms(dev):
    """Host-recode CHES, BGMW95 and stock Pippenger at n = 2^16 on one plan
    holding all three tables, BGMW and stock with both bucket strategies.
    The plan build and each query path count their launches on their own
    (counts set to 0 just before, read just after). Returns the counts by
    path."""
    from msm_blst_tpu_torch.curves import G1
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_bgmw_device, msm_ches_host_recode,
                                        msm_stock_pippenger, params, recode)

    n = 1 << N_LOG
    cfg = params.CONFIGS[N_LOG]
    check = oracle_check(n)
    host = {s: recode.random_scalars(n, s) for s in (WARM_SEED,) + ALGO_SEEDS}
    scalars = {s: recode.to_device(a, dev) for s, a in host.items()}
    reset_counts()
    t0 = time.perf_counter()
    plan = build_plan(G1, fixed_point_list(G1, n, device=dev), cfg)
    torch.cuda.synchronize()
    print(f"algorithms: n=2^{N_LOG}, plan with 3nh {tuple(plan.table3nh.XY.shape)},"
          f" nh {tuple(plan.table_nh.XY.shape)} (c'={cfg.c_bgmw}, "
          f"h'={cfg.h_bgmw}), points; fixed points + plan "
          f"{time.perf_counter() - t0:.3f} s")
    paths = {"algorithms_plan": read_counts("algorithms_plan", [
        "mont_mul", "point_dadd_affine", "point_dadd", "point_double"])}
    queries = [
        ("ches_host_recode", "prefix", lambda s: msm_ches_host_recode(
            plan, host[s], bucket_impl="prefix"), ALGO_SEEDS),
        ("bgmw_prefix", "prefix", lambda s: msm_bgmw_device(
            plan, scalars[s], bucket_impl="prefix"), ALGO_SEEDS),
        ("bgmw_segmented", "segmented", lambda s: msm_bgmw_device(
            plan, scalars[s], bucket_impl="segmented"), ALGO_SEEDS),
        ("stock_prefix", "prefix", lambda s: msm_stock_pippenger(
            plan, scalars[s], bucket_impl="prefix"), ALGO_SEEDS[:2]),
        ("stock_segmented", "segmented", lambda s: msm_stock_pippenger(
            plan, scalars[s], bucket_impl="segmented"), ALGO_SEEDS[:2]),
    ]
    for name, impl, query, seeds in queries:
        reset_counts()
        check(WARM_SEED, query(WARM_SEED))
        times = []
        for s in seeds:
            torch.cuda.synchronize()
            t = time.perf_counter()
            jac = query(s)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            check(s, jac)
        print(f"algorithms: {name}: {len(seeds)} queries equal to the oracle;"
              f" query mean {1e3 * sum(times) / len(times):.3f} ms, min "
              f"{1e3 * min(times):.3f} ms")
        other = [k for s, ks in STRATEGY_KERNELS.items() if s != impl
                 for k in ks]
        paths[name] = read_counts(name, QUERY_KERNELS + STRATEGY_KERNELS[impl],
                                  unused=other)
    return paths


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
    "seg_level_affine": ("msm_blst_tpu_torch/csrc/seg.cu",
                         "msm_blst_tpu/msm/pallas_scan.py:93"),
    "seg_level_xyzz": ("msm_blst_tpu_torch/csrc/seg.cu",
                       "msm_blst_tpu/msm/pallas_scan.py:93"),
}


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    results = phase_kernels(dev)
    paths = {"ches_device": phase_main_path(dev), **phase_algorithms(dev)}
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {k: p[name] for k, p in paths.items()},
         **results[name]}
        for name, (src, rep) in SOURCES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

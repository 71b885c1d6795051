"""Time K6 (the SOS multiply) of one checkout of the port on the card, beside
K1, and report how that checkout builds K6.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/sos_timing.py [--tree DIR] [--out report.json]

`--tree` names a directory whose `msm_blst_tpu_torch` is timed instead of
this checkout's (a parent commit's, or a copy with one build choice
changed), so that versions are timed by one script with one timer: run it
once a tree, alternating, one after another on one card. Every input is made
here from a numpy seed, the same in every tree:

* K6 at each stage (`sos.sos_stage`: prod, bytes, mm1, full) and K1
  (`cuda_mont.mont_mul`) on 2^20 operand pairs and on COLUMN = 10,752
  pairs, the chunk columns of the batch inversion of a CONFIGS[16] CHES
  table (2,752,512 elements in `utils/scans.pick_chunk`'s 256 columns),
  each checked word for word against its plain version, timed with
  `utils/profiling.device_ms` (at the column shape also `graph_ms`, a CUDA
  graph of 20 calls, and the profiler's kernel time: `device_ms` there
  times the host's launch work), with a SHA-256 of its words (the words must
  match across trees);
* the SOS plan build of the CHES query at n = 2^16 (CONFIGS[16]): the
  fixed points and `build_plan(..., mul_impl="sos")`, host seconds ending
  in a synchronize, and one SOS CHES query (`msm_ches_device`) by
  `device_ms`, with a SHA-256 of its affine result, G1 and G2.

Before the timings it prints the card's name and power limit, sos_mul.cu's
nvcc seconds, the ptxas lines of its kernels, from a probe built on the
checkout's sos_mul.cu (cudaFuncGetAttributes and
cudaOccupancyMaxActiveBlocksPerMultiprocessor at the source's THREADS)
each stage kernel's registers, static shared memory, local memory and
resident blocks an SM, and each stage kernel's SASS instructions by
opcode family (cuobjdump of the source built alone). One JSON object ends
the output.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

from timing_tools import ROOT, card, kernel_ms, own_timers, use_tree

COLUMN = 10752
STAGES = ("prod", "bytes", "mm1", "full")
N_LOG = 16  # the query and plan of chip_smoke's main path
PROBE = r'''
#include "sos_mul.cu"
#include <cuda_runtime.h>

template <int S>
static int describe(int* out) {
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, sos_mul_kernel<S>);
  if (rc) return rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], sos_mul_kernel<S>, THREADS, 0);
}

extern "C" int sos_probe(int* out) {
  int rc = describe<0>(out);
  if (!rc) rc = describe<1>(out + 4);
  if (!rc) rc = describe<2>(out + 8);
  if (!rc) rc = describe<3>(out + 12);
  out[16] = THREADS;
  return rc;
}
'''


def operands(n: int, seed: int, dev) -> torch.Tensor:
    """n canonical Fp word vectors (top word below p's) from a numpy seed,
    with 0, 1 and p - 1 in the first three lanes (as chip_smoke's)."""
    from msm_blst_tpu_torch.constants import P
    from msm_blst_tpu_torch.fields.limb import ints_to_array

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2 ** 32, size=(12, n), dtype=np.uint64)
    w[11] %= P >> 352
    w[:, :3] = ints_to_array([0, 1, P - 1], 12).view(np.uint32)
    return torch.as_tensor(w.astype(np.uint32).view(np.int32), device=dev)


def digest(*tensors) -> str:
    return hashlib.sha256(b"".join(t.contiguous().cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


def probe() -> dict:
    """{stage: {registers, smem_bytes, local_bytes, blocks_per_sm}} of the
    checkout's K6 kernels, and the block size, from a probe built on its
    sos_mul.cu."""
    from msm_blst_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        src = os.path.join(tmp, "sos_probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        so = os.path.join(tmp, "sos_probe.so")
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-I",
                        str(kernels.CSRC), "-o", so, src], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        out = (ctypes.c_int * 17)()
        rc = lib.sos_probe(out)
        if rc:
            raise RuntimeError(f"sos_probe: CUDA error {rc}")
    keys = ("registers", "smem_bytes", "local_bytes", "blocks_per_sm")
    rep = {stage: dict(zip(keys, out[4 * i: 4 * i + 4]))
           for i, stage in enumerate(STAGES)}
    rep["threads"] = out[16]
    return rep


# SASS opcode families counted in each stage kernel
SASS_KINDS = ("IMAD", "IADD3", "LOP3", "SEL", "SHF", "SHFL", "IMMA", "LDS",
              "STS", "LDG", "STG")


def sass_counts() -> dict:
    """{stage: {"instructions", opcode family: count}} of the checkout's K6
    kernels, from its sos_mul.cu built to a cubin and read with cuobjdump
    (static counts: a loop body counts once)."""
    from msm_blst_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        cubin = os.path.join(tmp, "sos_mul.cubin")
        subprocess.run([nvcc, "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                        "-o", cubin, str(kernels.CSRC / "sos_mul.cu")],
                       check=True, capture_output=True)
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
            check=True, capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"sos_mul_kernelILi(\d)E", part.split()[0])
        if not m:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", part)
        rec = {"instructions": len(ops)}
        for kind in SASS_KINDS:
            rec[kind] = sum(op.split(".")[0] == kind for op in ops)
        out[STAGES[int(m.group(1))]] = rec
    return out


def build_report() -> dict:
    from msm_blst_tpu_torch import kernels

    kernels.load()
    log = kernels.library_path().with_suffix(".log").read_text()
    return {"nvcc_s": {m.group(1): float(m.group(2)) for m in re.finditer(
                r"^nvcc (\S+): ([\d.]+) s$", log, re.M)
                if m.group(1) == "sos_mul.cu"},
            "ptxas": {k: v for k, v in kernels.ptxas_summary().items()
                      if k.startswith("sos_mul.cu")},
            "probe": probe(), "sass": sass_counts()}


def kernel_times(dev, report, timers):
    from msm_blst_tpu_torch.fields import FP, cuda_mont, sos

    for n, reps in ((1 << 20, 20), (COLUMN, 200)):
        a = operands(n, 11, dev)
        b = operands(n, 12, dev).flip(1).contiguous()
        runs = {f"sos_mul_{s}" if s != "full" else "sos_mul":
                (lambda s=s: sos.sos_stage(a, b, FP, s),
                 lambda s=s: sos.sos_stage_plain(a, b, FP, s))
                for s in STAGES}
        runs["mont_mul"] = (lambda: cuda_mont.mont_mul(a, b, FP),
                            lambda: cuda_mont.mont_mul_plain(a, b, FP))
        for name, (fn, plain) in runs.items():
            key = f"{name} {n}"
            got = fn()
            if not torch.equal(got, plain()):
                report["differs"].append(key)
            report["words"][key] = digest(got)
            report["ms"][key] = timers.device_ms(fn, reps)
            if n == COLUMN:  # device_ms times the host's launch work here
                report["ms"][key + " graph"] = timers.graph_ms(fn)
                report["ms"][key + " kernel"] = kernel_ms(fn)[0]
        if not torch.equal(runs["sos_mul"][0](), runs["mont_mul"][0]()):
            report["differs"].append(f"sos_mul {n} against mont_mul")
        del a, b
        torch.cuda.empty_cache()


def path_times(dev, report, timers):
    from msm_blst_tpu_torch import curves
    from msm_blst_tpu_torch.msm import (build_plan, fixed_point_list,
                                        msm_ches_device, params, recode)

    n, cfg = 1 << N_LOG, params.CONFIGS[N_LOG]
    scalars = recode.to_device(recode.random_scalars(n, 2), dev)
    for curve in (curves.G1, curves.G2):
        for rep in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            points = fixed_point_list(curve, n, device=dev, mul_impl="sos")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plan = build_plan(curve, points, cfg, bgmw=False, stock=False,
                              mul_impl="sos")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            report["s"][f"{curve.name} sos fixed points ({rep})"] = t1 - t0
            report["s"][f"{curve.name} sos plan build ({rep})"] = t2 - t1
        jac = msm_ches_device(plan, scalars)
        report["words"][f"{curve.name} sos plan"] = digest(*plan.table3nh)
        report["words"][f"{curve.name} sos ches query"] = digest(
            *plan.curve.jac_to_affine(jac))
        report["ms"][f"{curve.name} sos ches query"] = timers.device_ms(
            lambda: msm_ches_device(plan, scalars), 5)
        del plan, points
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sos_timing.py needs a CUDA device")
    tree = use_tree(args.tree)
    timers = own_timers()
    smi = card()
    print(smi)
    print(f"tree {tree}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {"tree": tree, "card": smi, **build_report(), "ms": {}, "s": {},
              "words": {}, "differs": []}
    print(f"nvcc {report['nvcc_s']}")
    for k, v in sorted(report["ptxas"].items()):
        print(f"ptxas {k}: {v}")
    print(f"probe {report['probe']}")
    for stage, rec in report["sass"].items():
        print(f"sass {stage}: {rec}")
    kernel_times(dev, report, timers)
    path_times(dev, report, timers)
    for k, v in report["ms"].items():
        print(f"{k}: {v:.4f} ms")
    for k, v in report["s"].items():
        print(f"{k}: {v:.3f} s")
    for k, v in report["words"].items():
        print(f"{k}: words {v}")
    for k in report["differs"]:
        print(f"{k}: differs")
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Time K2's launches of one checkout of the port on the card, and report
how that checkout builds them.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/k2_timing.py [--tree DIR] [--out report.json]

`--tree` names a directory whose `msm_blst_tpu_torch` is timed instead of
this checkout's (a parent commit's, or a copy with one build choice
changed), so that versions are timed by one script with one timer: run it
once a tree, alternating, in one session on one card. The inputs are this
checkout's chip_smoke.py's (`k2_lanes`, `ches_level`), made by the tree's
package:

* K2's dadd_affine, dadd and double at 2^16 lanes, each checked word for
  word against its plain twin, timed with `utils/profiling.device_ms`;
* the whole `prefix_pipeline.buckets_from_boundaries` on the CHES level of
  one CONFIGS[16] recode (109,244 buckets: K4 over the lane tails,
  searchsorted, then K2), and K2's boundary launch alone
  (`cuda_point.bucket_diffs`, where the checkout has it, checked against
  its plain twin), `device_ms`;
* the Horner combine of six gap groups (`cuda_point.gap_horner`, checked
  against its plain twin; in a checkout without it, the loop of K2 adds
  and doublings `engine.integrate_gapped` ran) and a one-lane dadd, the
  card alone (chip_smoke's `queued_ms`).

The outputs of the boundaries and the Horner combine are also given as a
SHA-256 of their words, so that two checkouts can be seen to compute the
same words. Before the timings it prints the card's name and power limit,
each K2 source's nvcc seconds (where the checkout's build log has them),
the registers, stack and spills of its K2 kernels, their resident blocks
an SM (where the checkout reports them), and the SASS instructions of one
Fp product by fp.cuh's mont_mul and, where the checkout has
csrc/k2_mul.cuh, by its carry chains (a probe kernel built on the
checkout's headers, counted with cuobjdump -sass). One JSON object ends
the output.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import tempfile

import torch

from timing_tools import ROOT, card, use_tree

K2_SOURCES = ("point_ops.cu", "point_ops_g2.cu")
REPS = 20
PROBE = r'''
#include "fp.cuh"
extern "C" __global__ void probe_fp(const msm::Fp* a, const msm::Fp* b,
                                    msm::Fp* r) {
  msm::fp_mul(r[threadIdx.x], a[threadIdx.x], b[threadIdx.x]);
}
#if __has_include("k2_mul.cuh")
#include "k2_mul.cuh"
extern "C" __global__ void probe_k2(const msm::FpK2* a, const msm::FpK2* b,
                                    msm::FpK2* r) {
  msm::fp_mul(r[threadIdx.x], a[threadIdx.x], b[threadIdx.x]);
}
#endif
'''


def smoke():
    """This checkout's chip_smoke.py as a module (its main does not run)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_counts() -> dict:
    """{product: {"instructions", "imad"}} of the probe kernels (one Fp
    product, its 24 word loads and 12 stores), built on the checkout's
    csrc headers."""
    from msm_blst_tpu_torch import kernels

    nvcc = kernels.nvcc_path()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([nvcc, "-cubin", "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                        "-I", str(kernels.CSRC), "-o", cubin, src],
                       check=True, capture_output=True)
        sass = subprocess.run(
            [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
            check=True, capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_.]*)", part)
        out[{"probe_fp": "fp.cuh", "probe_k2": "k2_mul.cuh"}[name]] = {
            "instructions": len(ops),
            "imad": sum(op.startswith("IMAD") for op in ops)}
    return out


def build_report() -> dict:
    from msm_blst_tpu_torch import kernels

    kernels.load()
    log = kernels.library_path().with_suffix(".log").read_text()
    rep = {"nvcc_s": {m.group(1): float(m.group(2)) for m in re.finditer(
               r"^nvcc (\S+): ([\d.]+) s$", log, re.M)
               if m.group(1) in K2_SOURCES},
           "ptxas": {k: v for k, v in kernels.ptxas_summary().items()
                     if k.split()[0] in K2_SOURCES},
           "sass": sass_counts()}
    if "point_bucket_diffs" in getattr(kernels, "OCCUPANCY", {}):
        rep["occupancy"] = {c: kernels.occupancy(c, "point_bucket_diffs")
                            for c in kernels.CURVE_KERNELS}
    return rep


def horner(curve, sums, present):
    """The checkout's Horner combine of the gap groups `sums`: one launch,
    or the K2 launches of integrate_gapped's loop before it."""
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point

    if hasattr(cuda_point, "gap_horner"):
        return cuda_point.gap_horner(curve, sums, present)
    parts = [XyzzPoint(*(c[..., g:g + 1] for c in sums)) if p else None
             for g, p in enumerate(present)]
    acc = None
    for bit in range(len(parts).bit_length() - 1, -1, -1):
        sel = [s for g, s in enumerate(parts, start=1)
               if ((g >> bit) & 1) and s is not None]
        part = None
        for s in sel:
            part = s if part is None else curve.xyzz_dadd(part, s)
        if acc is not None:
            acc = curve.xyzz_double(acc)
            if part is not None:
                acc = curve.xyzz_dadd(acc, part)
        else:
            acc = part
    return acc


def digest(point) -> str:
    return hashlib.sha256(b"".join(c.contiguous().cpu().numpy().tobytes()
                                   for c in point)).hexdigest()[:16]


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def curve_times(sm, curve, dev, report):
    from msm_blst_tpu_torch.curves import XyzzPoint, cuda_point
    from msm_blst_tpu_torch.msm import fixed_point_list, params, prefix_pipeline
    from msm_blst_tpu_torch.msm import scan
    from msm_blst_tpu_torch.utils.profiling import device_ms

    ms, words = report["ms"], report["words"]
    pts = fixed_point_list(curve, 1 << sm.N_LOG, device=dev)
    acc, other, signs = sm.k2_lanes(curve, pts)
    cp = cuda_point
    for op, fn, plain in (
            (f"dadd_affine 2^{sm.N_LOG}",
             lambda: cp.xyzz_dadd_affine(curve, acc, pts, signs),
             lambda: cp.xyzz_dadd_affine_plain(curve, acc, pts, signs)),
            (f"dadd 2^{sm.N_LOG}", lambda: cp.xyzz_dadd(curve, acc, other),
             lambda: cp.xyzz_dadd_plain(curve, acc, other)),
            (f"double 2^{sm.N_LOG}", lambda: cp.xyzz_double(curve, acc),
             lambda: cp.xyzz_double_plain(curve, acc))):
        if not same(fn(), plain()):
            report["differs"].append(f"{curve.name} {op}")
        ms[f"{curve.name} {op}"] = device_ms(fn, REPS)

    keys_s, local, tails, c, n_ch = sm.ches_level(curve, pts)
    nb = params.CONFIGS[sm.N_LOG].b_size
    key = f"{curve.name} buckets_from_boundaries {nb}"
    whole = lambda: prefix_pipeline.buckets_from_boundaries(  # noqa: E731
        curve, local, tails, keys_s, nb, c, n_ch)
    words[key] = digest(whole())
    ms[key] = device_ms(whole, REPS)
    if hasattr(cp, "bucket_diffs"):
        incl = scan.prefix_scan_xyzz(curve, tails)
        right = torch.searchsorted(
            keys_s, torch.arange(nb, dtype=torch.int32, device=dev),
            right=True, out_int32=True)
        fn = lambda: cp.bucket_diffs(curve, right, local, incl, c,  # noqa
                                     n_ch)
        if not same(fn(), cp.bucket_diffs_plain(curve, right, local, incl, c,
                                                n_ch)):
            report["differs"].append(f"{curve.name} bucket_diffs {nb}")
        ms[f"{curve.name} bucket_diffs {nb}"] = device_ms(fn, REPS)
    del local, tails

    d_max = params.CONFIGS[sm.N_LOG].d_max
    sums = XyzzPoint(*(x[..., :d_max].contiguous() for x in acc))
    present = [True] * d_max
    key = f"{curve.name} horner {d_max} groups"
    words[key] = digest(horner(curve, sums, present))
    if hasattr(cp, "gap_horner_plain") and not same(
            horner(curve, sums, present),
            cp.gap_horner_plain(curve, sums, present)):
        report["differs"].append(key)
    ms[key + " (alone)"] = sm.queued_ms(lambda: horner(curve, sums, present),
                                        50)
    one = XyzzPoint(*(x[..., 3:4].contiguous() for x in acc))
    two = XyzzPoint(*(x[..., 4:5].contiguous() for x in acc))
    ms[f"{curve.name} dadd 1 lane (alone)"] = sm.queued_ms(
        lambda: cp.xyzz_dadd(curve, one, two), 50)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_timing.py needs a CUDA device")
    tree = use_tree(args.tree)
    sm = smoke()
    from msm_blst_tpu_torch import curves

    smi = card()
    print(smi)
    print(f"tree {tree}")
    report = {"tree": tree, "card": smi, **build_report(), "ms": {},
              "words": {}, "differs": []}
    print(f"nvcc {report['nvcc_s']}; occupancy {report.get('occupancy')}; "
          f"SASS of one Fp product {report['sass']}")
    for k, v in sorted(report["ptxas"].items()):
        print(f"ptxas {k}: {v}")
    dev = torch.device("cuda", 0)
    for curve in (curves.G1, curves.G2):
        curve_times(sm, curve, dev, report)
        torch.cuda.empty_cache()
    for k, v in report["ms"].items():
        print(f"{k}: {v:.4f} ms")
    for k, v in report["words"].items():
        print(f"{k}: words {v}")
    for k in report["differs"]:
        print(f"{k}: differs from the plain twin")
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

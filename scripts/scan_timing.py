"""Time the whole inclusive xyzz prefix scan, `prefix_scan_xyzz`, of one
checkout of the port on the card.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/scan_timing.py [--tree DIR] [--out report.json]

`--tree` names the root of another checkout whose `msm_blst_tpu_torch` is
timed instead of this one's, so that two versions are timed by one
script with one timer: run it once a tree, alternating, in one session on
one card. The function is looked up in `msm/scan.py` and, for checkouts
older than the block scan, in `msm/cuda_scan.py` (the column walk with
its chunk-tail scan and carry). Each call is timed whole, with
`utils/profiling.device_ms` (CUDA events around back-to-back calls, so
host issue counts where it is slower than the card), on G1 and G2 at the
stream lengths of the query paths at n = 2^16: 109,243 (the CHES
integration's suffix scan), 8,192 (the K3 level's chunk tails), 2,048
and 64 (stock). The stream is the first N of one 109,243-point xyzz
batch: doubled lifts of 64 fixed points drawn with a numpy seed. Prints
the card's name and power limit, one line a length and one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

LENGTHS = (109243, 8192, 2048, 64)
REPS = 10
SEED = 0


def _scan_fn(tree: str):
    sys.path.insert(0, os.path.abspath(tree))
    for mod in ("scan", "cuda_scan"):
        m = importlib.import_module(f"msm_blst_tpu_torch.msm.{mod}")
        if hasattr(m, "prefix_scan_xyzz"):
            return m.__name__, m.prefix_scan_xyzz
    raise SystemExit(f"{tree}: no prefix_scan_xyzz in msm/scan.py or "
                     "msm/cuda_scan.py")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_timing.py needs a CUDA device")
    where, prefix_scan_xyzz = _scan_fn(args.tree)
    from msm_blst_tpu_torch.curves import G1, G2, XyzzPoint
    from msm_blst_tpu_torch.msm import fixed_point_list
    from msm_blst_tpu_torch.utils.profiling import device_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    print(f"tree {os.path.abspath(args.tree)}: {where}.prefix_scan_xyzz")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    report = {"tree": os.path.abspath(args.tree), "module": where,
              "card": card.strip(), "ms": {}}
    for curve in (G1, G2):
        base = curve.xyzz_double(curve.xyzz_from_affine(
            fixed_point_list(curve, 64, device=dev)))
        idx = torch.as_tensor(rng.integers(0, 64, max(LENGTHS)), device=dev)
        pts = XyzzPoint(*(c[..., idx].contiguous() for c in base))
        for N in LENGTHS:
            head = XyzzPoint(*(c[..., :N].contiguous() for c in pts))
            ms = device_ms(lambda: prefix_scan_xyzz(curve, head), REPS)
            report["ms"][f"{curve.name} {N}"] = ms
            print(f"{curve.name} N={N}: {ms:.4f} ms a call (device_ms, "
                  f"{REPS} calls)")
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Step-wise timing of the SOS Montgomery multiply on the card (port of
drivers/mxu_experiment.py): where the reduction's cost lives, beside the
CIOS multiply.

Variants, all bit-identical where they produce full results:
  cios        K1, the CIOS kernel (baseline)
  prod        K6's "prod" stage: the full product only (a*b mod R out)
  prod+bytes  + staging T's bytes as the tensor cores' B operand
  prod+mm1    + the first Toeplitz product (m = a*b*P' mod R out)
  sos         K6, the whole SOS multiply
  sos_wide    the JAX driver's SOS with E and O rows fused into one
              matrix; K6 fuses them already, so on the card sos and
              sos_wide are one kernel, timed again under this name

`sos` must equal `cios` on the first 256 lanes, and every stage its plain
version there. Prints one JSON line per variant (CUDA events; the host's
clock with --device cpu). Run:

    python -m msm_blst_tpu_torch.drivers.mxu_experiment [B] [reps]
        [--loops N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..constants import P
from ..device import resolve
from ..fields import cuda_mont, sos
from ..fields.limb import FP
from ..utils.profiling import device_name, time_ms

# variant -> (kernel's name in kernels.py, the call)
VARIANTS = {
    "cios": ("mont_mul", lambda a, b: cuda_mont.mont_mul(a, b, FP)),
    "prod": ("sos_mul_prod", lambda a, b: sos.sos_stage(a, b, FP, "prod")),
    "prod+bytes": ("sos_mul_bytes",
                   lambda a, b: sos.sos_stage(a, b, FP, "bytes")),
    "prod+mm1": ("sos_mul_mm1", lambda a, b: sos.sos_stage(a, b, FP, "mm1")),
    "sos": ("sos_mul", lambda a, b: sos.sos_mul(a, b, FP)),
    "sos_wide": ("sos_mul", lambda a, b: sos.sos_mul(a, b, FP)),
}
PLAIN = {"prod": "prod", "prod+bytes": "bytes", "prod+mm1": "mm1",
         "sos": "full"}


def inputs(B: int, device=None):
    """The JAX driver's operands: 256 random values (47 random bytes mod p,
    seed 5) tiled to B lanes, Montgomery form."""
    rng = np.random.default_rng(5)
    a_i = [int.from_bytes(rng.bytes(47), "little") % P for _ in range(256)]
    b_i = [int.from_bytes(rng.bytes(47), "little") % P for _ in range(256)]
    reps = -(-B // 256)
    a = FP.from_ints(a_i, device=device).repeat(1, reps)[:, :B].contiguous()
    b = FP.from_ints(b_i, device=device).repeat(1, reps)[:, :B].contiguous()
    return a, b


def check(a, b):
    """sos == cios, and every stage == its plain version, on 256 lanes."""
    a, b = a[:, :256].contiguous(), b[:, :256].contiguous()
    want = VARIANTS["cios"][1](a, b)
    if not torch.equal(VARIANTS["sos"][1](a, b), want):
        raise AssertionError("sos mismatch vs cios")
    for variant, stage in PLAIN.items():
        got = VARIANTS[variant][1](a, b)
        if not torch.equal(got, sos.sos_stage_plain(a, b, FP, stage)):
            raise AssertionError(f"{variant} mismatch vs its plain version")


def run(B: int = 1 << 18, reps: int = 5, loops: int = 8, device=None) -> list:
    device = resolve(device)
    a, b = inputs(B, device)
    check(a, b)
    print(f"# correctness OK; B={B} loops={loops}; sos and sos_wide are one "
          "kernel on the card (K6 fuses the E and O rows)", flush=True)
    out, t_by = [], {}
    for name, (kernel, fn) in VARIANTS.items():
        def call():
            for _ in range(loops):
                fn(a, b)
        ms = time_ms(call, device, reps) / loops
        t_by[name] = ms
        rec = {"variant": name, "kernel": kernel, "ms": ms,
               "muls_per_s": float(f"{B / (ms * 1e-3):.4g}"), "B": B,
               "loops": loops, "device": device_name(device)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    print(f"# deltas: bytes-marshal {t_by['prod+bytes'] - t_by['prod']:.4f} "
          f"ms, mm1 {t_by['prod+mm1'] - t_by['prod+bytes']:.4f} ms, rest "
          f"{t_by['sos'] - t_by['prod+mm1']:.4f} ms", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("B", nargs="?", type=int, default=1 << 18)
    ap.add_argument("reps", nargs="?", type=int, default=5)
    ap.add_argument("--loops", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu for a CPU run")
    args = ap.parse_args(argv)
    run(args.B, args.reps, args.loops, device=args.device)


if __name__ == "__main__":
    main()

"""Gather formulations on the card (port of drivers/gather_bench.py): the
table-point gather every bucket pass runs, and K8, a gather from a table
held on chip.

  t1d        torch.take from a 64K int32 table, 512K random indices
  t1d_sort   the same, ascending indices
  row96      affine row gather (N, 24) words (index_select), 96 B rows
  row_pair   the same with X||Y packed in one (N, 48) row, 192 B rows
  kern_smem  K8 (csrc/gather_smem.cu): the table in the distributed
             shared memory of 2-CTA clusters; must equal t1d

Prints one JSON line per row (CUDA events; the host's clock with --device
cpu). Run:

    python -m msm_blst_tpu_torch.drivers.gather_bench [--device cpu] [--quick]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve
from ..kernels import GATHER_SMEM, on_cpu, ptr
from ..utils.profiling import device_name, time_ms

T, N = 65537, 1 << 19
# the largest table two CTAs hold: 2 x 227 KB of int32
MAX_TABLE = 2 * 232448 // 4


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j] = table[idx[j]]."""
    return table.index_select(0, idx.to(torch.int64))


def gather_smem(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8 for CUDA tensors (int32 1-D, idx in [0, len(table))), the plain
    version for CPU tensors."""
    if on_cpu(table, idx):
        return gather_plain(table, idx)
    for t in (table, idx):
        if (t.device.type != "cuda" or t.dtype != torch.int32 or t.ndim != 1
                or not t.is_contiguous() or t.device != table.device):
            raise ValueError(f"{GATHER_SMEM.symbol}: expected contiguous "
                             "1-D int32 CUDA tensors on one device")
    if table.numel() > MAX_TABLE:
        raise ValueError(f"{GATHER_SMEM.symbol}: table of {table.numel()} "
                         f"entries, at most {MAX_TABLE}")
    out = torch.empty_like(idx)
    GATHER_SMEM(ptr(table), ptr(idx), ptr(out), table.numel(), idx.numel())
    return out


def inputs(T: int = T, N: int = N, device=None) -> dict:
    """The JAX driver's data (seed 1): the table, its int32 indices (and
    as int64, torch.take's index type; sorted too), and the row tables with
    their half-length indices."""
    device = resolve(device)
    rng = np.random.default_rng(1)

    def dev(x):
        return torch.as_tensor(x, device=device)

    idx = dev(rng.integers(0, T, size=N).astype(np.int32))
    data = {"table": dev(rng.integers(0, 1 << 30, size=T).astype(np.int32)),
            "idx": idx, "idx64": idx.to(torch.int64),  # torch.take's index
            "idx_sorted": torch.sort(idx).values.to(torch.int64)}
    data["rows"] = dev(rng.integers(0, 1 << 30, size=(T, 24)).astype(np.int32))
    data["ridx"] = dev(rng.integers(0, T, size=N // 2).astype(np.int64))
    data["rows48"] = dev(rng.integers(0, 1 << 30, size=(T, 48)).astype(np.int32))
    return data


def run(T: int = T, N: int = N, device=None, reps: int = 5) -> list:
    device = resolve(device)
    d = inputs(T, N, device)
    want = torch.take(d["table"], d["idx64"])
    if not torch.equal(gather_smem(d["table"], d["idx"]), want):
        raise AssertionError("kern_smem differs from torch.take")
    Np = N // 2
    rows = {  # name: (call, elements, bytes an element)
        "t1d": (lambda: torch.take(d["table"], d["idx64"]), N, 4),
        "t1d_sort": (lambda: torch.take(d["table"], d["idx_sorted"]), N, 4),
        "row96": (lambda: d["rows"].index_select(0, d["ridx"]), Np, 96),
        "row_pair": (lambda: d["rows48"].index_select(0, d["ridx"]), Np, 192),
        "kern_smem": (lambda: gather_smem(d["table"], d["idx"]), N, 4),
    }
    out = []
    for name, (fn, n, width) in rows.items():
        ms = time_ms(fn, device, reps)
        rec = {"row": name, "ms": ms,
               "elems_per_s": float(f"{n / (ms * 1e-3):.4g}"),
               "gb_per_s": float(f"{n * width / (ms * 1e-3) / 1e9:.4g}"),
               "n": n, "device": device_name(device)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the card by default; cpu for a CPU run")
    ap.add_argument("--quick", action="store_true",
                    help="a 4097-entry table and 2^12 indices (a CPU run)")
    args = ap.parse_args(argv)
    if args.quick:
        run(4097, 1 << 12, device=args.device)
    else:
        run(device=args.device)


if __name__ == "__main__":
    main()

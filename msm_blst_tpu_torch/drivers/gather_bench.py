"""Gather formulations on the card (port of drivers/gather_bench.py): the
table-point gather every bucket pass runs, and K8, a gather from a table
held on chip.

  t1d        torch.take from a 64K int32 table, 512K random indices
  t1d_sort   the same, ascending indices
  row96      affine row gather (N, 24) words (index_select), 96 B rows
  row_pair   the same with X||Y packed in one (N, 48) row, 192 B rows
  kern_smem  K8 (csrc/gather_smem.cu): the table split over the
             distributed shared memory of 2-CTA clusters, filled by TMA;
             must equal t1d

Prints one JSON line per row (CUDA events; the host's clock with --device
cpu). Run:

    python -m msm_blst_tpu_torch.drivers.gather_bench [--device cpu] [--quick]
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..device import resolve
from ..kernels import GATHER_SMEM, load, on_cpu
from ..utils.profiling import device_name, time_ms

T, N = 65537, 1 << 19
# K8's cluster: the CTAs that split the table between them. Wider clusters
# copy less of the table in but cost more in lookups (PERF.md §6)
CLUSTER = 2
# the entries one CTA holds: 227 KB of shared memory less 16 B for the
# fill's mbarrier, in whole 16-byte steps
SLICE_MAX = (232448 - 16) // 16 * 4
MAX_TABLE = CLUSTER * SLICE_MAX


def gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[j] = table[idx[j]]."""
    return table.index_select(0, idx.to(torch.int64))


def cluster_capacity(T: int) -> int:
    """The clusters of K8 the card keeps resident at once for a table of T
    entries (cudaOccupancyMaxActiveClusters; 0: it cannot launch them)."""
    n = ctypes.c_int()
    rc = load().msm_gather_smem_clusters(T, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"msm_gather_smem_clusters: CUDA error {rc}")
    return n.value


def gather_smem(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K8 for CUDA tensors (int32 1-D, idx in [0, len(table))), the plain
    version for CPU tensors. A view that does not start on 16 bytes (the
    bulk copy's and the int4 loads' step) is copied to one that does
    first. A table above MAX_TABLE, or a failed launch, raises."""
    if on_cpu(table, idx):
        return gather_plain(table, idx)
    if not (table.is_cuda and idx.device == table.device
            and table.dtype == idx.dtype == torch.int32
            and table.dim() == idx.dim() == 1
            and table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{GATHER_SMEM.symbol}: expected contiguous "
                         "1-D int32 CUDA tensors on one device")
    T, n = table.numel(), idx.numel()
    if T > MAX_TABLE:
        raise ValueError(f"{GATHER_SMEM.symbol}: table of {T} entries, at "
                         f"most {MAX_TABLE}")
    tp, ip = table.data_ptr(), idx.data_ptr()
    if tp & 15:
        table = table.clone()
        tp = table.data_ptr()
    if ip & 15:
        idx = idx.clone()
        ip = idx.data_ptr()
    out = torch.empty_like(idx)
    if n:
        GATHER_SMEM(tp, ip, out.data_ptr(), T, n)
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

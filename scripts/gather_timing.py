"""Time K8, the gather from a table held in on-chip shared memory
(`drivers/gather_bench.py` `gather_smem`), and `torch.take` on the same
table and indices, of one checkout of the port on the card, so that the
kernel's own time is seen apart from its launch path.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/gather_timing.py [--tree DIR] [--shapes T:N ...]
                                     [--out report.json]

`--tree` names the root of another checkout whose `msm_blst_tpu_torch` is
timed instead of this one's, with this checkout's timers: run it once a
tree, alternating, on one card. The data is the gather
bench's (`gather_bench.inputs`, seed 1): T = 65,537 int32 entries and N =
2^19 indices, or each `T:N` of `--shapes`. Every K8 output is held equal to
`torch.take`'s first. Each function is timed by
* `device_ms`: CUDA events around 20 back-to-back calls (the timer of
  PERF.md's kernel table and of `chip_smoke.py`; where the host takes
  longer to issue a call than the card to run it, the host's time);
* `graph_ms`: the same 20 calls in one CUDA graph, replayed 10 times
  under CUDA events (no launch work; the gaps between kernels count);
* `kernel_ms`: torch.profiler's device time of the 20 calls' kernels;
* `host_us`: the host's clock over 200 calls issued without waiting.
At the first shape it also times, by `host_us`, the pieces of K8's call:
its launch alone (`GATHER_SMEM` on ready pointers: `Kernel.__call__`, the
ctypes call and the C side), `torch.empty_like` of the output and
`torch.cuda.current_stream()`; the wrapper's Python checks are the rest.

Prints the card's name and power limit, K8's registers and spills as ptxas
reported them, one line a measurement and one JSON object.
"""

from __future__ import annotations

import argparse
import json

import torch

from timing_tools import ROOT, card, host_us, kernel_ms, own_timers, use_tree

CALLS = 20
REPLAYS = 10


def time_shape(gather_bench, T, N, dev, timers) -> list:
    """One record a function (K8, torch.take) at a table of T entries and
    N indices."""
    d = gather_bench.inputs(T, N, device=dev)
    table, idx, idx64 = d["table"], d["idx"], d["idx64"]
    fns = {"gather_smem": lambda: gather_bench.gather_smem(table, idx),
           "torch_take": lambda: torch.take(table, idx64)}
    if not torch.equal(fns["gather_smem"](), fns["torch_take"]()):
        raise AssertionError("gather_smem differs from torch.take")
    rows = []
    for name, fn in fns.items():
        rec = {"name": name, "T": T, "N": N,
               "device_ms": timers.device_ms(fn, CALLS),
               "graph_ms": timers.graph_ms(fn, CALLS, REPLAYS),
               "host_us": host_us(fn)}
        rec["kernel_ms"], rec["kernels"] = kernel_ms(fn, CALLS)
        print(f"T {T}, N {N}: {name}: device_ms {rec['device_ms']:.5f}, "
              f"graph_ms {rec['graph_ms']:.5f}, kernel_ms "
              f"{rec['kernel_ms']:.5f}, host_us {rec['host_us']:.3f}; "
              + ", ".join(f"{k['kernel']} ×{k['count']}"
                          for k in rec["kernels"]), flush=True)
        rows.append(rec)
    return rows


def host_pieces(gather_bench, GATHER_SMEM, dev) -> dict:
    """`host_us` of K8's whole call and of its pieces at the bench's shape."""
    d = gather_bench.inputs(device=dev)
    table, idx = d["table"], d["idx"]
    out = torch.empty_like(idx)
    args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.numel(),
            idx.numel())
    return {"gather_smem": host_us(lambda: gather_bench.gather_smem(table, idx)),
            "launch": host_us(lambda: GATHER_SMEM(*args)),
            "empty_like": host_us(lambda: torch.empty_like(idx)),
            "current_stream": host_us(
                lambda: torch.cuda.current_stream().cuda_stream)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--shapes", nargs="*", default=["65537:524288"],
                    help="T:N, table entries and indices (default: "
                         "gather_bench's)")
    ap.add_argument("--out", help="also write the report here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_timing: torch sees no CUDA device")
    smi = card()
    print(smi)
    timers = own_timers()
    tree = use_tree(args.tree)
    from msm_blst_tpu_torch import kernels
    from msm_blst_tpu_torch.drivers import gather_bench

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.load()
    regs = {k: v for k, v in kernels.ptxas_summary().items()
            if k.startswith("gather_smem.cu")}
    print(f"tree {tree}: {regs}")
    report = {"device": smi, "tree": tree, "ptxas": regs, "rows": []}
    for shape in args.shapes:
        T, N = map(int, shape.split(":"))
        report["rows"] += time_shape(gather_bench, T, N, dev, timers)
    report["host_pieces_us"] = host_pieces(gather_bench, kernels.GATHER_SMEM,
                                           dev)
    print(f"host pieces (µs): {report['host_pieces_us']}")
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()

"""Build, load and launch the port's CUDA kernels (sources in csrc/).

The kernels are compiled at first use with nvcc — one process per source,
all started together, then one link — into one shared library with a plain
C interface, loaded with ctypes, and cached under `_build/` by a hash of the
sources. ptxas reports each kernel's registers and spills into a log beside
the library (`ptxas_summary`). Nothing here runs at import: the CPU tests
import every module of the port on a machine without nvcc or a card.

Each kernel entry point is a `Kernel`: calling it launches the kernel on
PyTorch's current stream, raises if the launch failed, and adds one to its
`launches` count — the count a run reads to show that it went through the
kernel. The table of them is here, in one place: K1 (`MONT_MUL`), each
curve's K2-K5 and K9 (`CURVE_KERNELS`), K6's stages (`SOS_MUL`), the
measurement drivers' K7 (`MADD_CHAIN`, by dtype) and K8 (`GATHER_SMEM`),
with the name a run reports each under, its C symbol and its source;
`occupancy` reads K2's, K3's, K4's and K5's resident blocks an SM,
`sos_occupancy` K6's, and `point_min_blocks` and `sos_min_blocks` the blocks
K2's and K6's launch bounds ask for (K8's cluster
capacity: `drivers/gather_bench.py` `cluster_capacity`).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libmsm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the cached shared library (no-op when built):
    every source in its own nvcc process, in parallel, then one link. The
    seconds each nvcc took go into the log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / (cu.stem + ".o") for cu in cus]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for cu, o in zip(cus, objs)]
        done = {}

        def wait(cu, proc):  # each nvcc's output and the seconds it took
            out = proc.communicate()[0]
            done[cu] = (out, proc.returncode, time.perf_counter() - t0)
        waits = [threading.Thread(target=wait, args=cp)
                 for cp in zip(cus, procs)]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        logs = [(cu, *done[cu][:2]) for cu in cus]
        secs = {cu: done[cu][2] for cu in cus}
        failed = [f"{cu.name} ({rc}):\n{out}" for cu, out, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp / so.name),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}{link.stdout}")
        so.with_suffix(".log").write_text(
            "".join(f"== {cu.name}\n{out}" for cu, out, _ in logs)
            + "".join(f"nvcc {cu.name}: {secs[cu]:.1f} s\n" for cu in cus))
        os.replace(tmp / so.name, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


# builtin types as template arguments (Itanium mangling)
_BUILTINS = {"j": "uint32_t", "i": "int", "f": "float"}


def _entry_name(symbol: str) -> str:
    """The unqualified name of a mangled kernel symbol: the last
    length-prefixed part of its (nested) name, with its template arguments
    when they are all integers or builtin types (K6's stage, K7's dtype):
    "sos_mul_kernel<3>", "madd_chain_kernel<float>"; class arguments (the
    coordinate field of K2-K5, whose curves have sources of their own) are
    left out."""
    i, name = (3 if symbol.startswith("_ZN") else 2), symbol
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        name, i = symbol[j: j + int(symbol[i:j])], j + int(symbol[i:j])
    m = re.match(r"I((?:Li-?\d+E|[jif])+)E", symbol[i:])
    if m:
        args = re.findall(r"Li(-?\d+)E|([jif])", m.group(1))
        name += "<" + ", ".join(v or _BUILTINS[t] for v, t in args) + ">"
    return name


def ptxas_summary() -> dict:
    """{"source entry": "N registers, F B stack frame, S B spill stores, L B
    spill loads"} for every kernel (`__global__` entry function) from the
    build log of the current library (built first if needed); the
    properties ptxas reports for a called device function (the Fp2
    multiply) are not a kernel's."""
    log = build().with_suffix(".log").read_text()
    out, entry, current, source = {}, None, None, ""
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = current = m.group(1)
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
        if entry is None or current != entry:
            continue
        name = f"{source} {_entry_name(entry)}"
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name] = (f"{m.group(1)} B stack frame, {m.group(2)} B spill "
                         f"stores, {m.group(3)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


def nvcc_seconds() -> dict:
    """{source: seconds its nvcc took} of the library's build, from its
    build log."""
    log = build().with_suffix(".log").read_text()
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^nvcc (\S+): ([\d.]+) s$", log, re.M)}


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

# The batch-size ranges `size_ranges` sums a kernel's launches into: one
# element (pow_int's chain), a scan's narrow levels, its chunk columns, the
# full-width products
SIZE_RANGES = (("<=1", 0, 1), ("2-1023", 2, 1023), ("1024-65535", 1024, 65535),
               ("65536+", 65536, None))


class Kernel:
    """One kernel's C entry point: `name` as runs report it, `op` (the name
    without its curve's prefix), its C `symbol` and `argtypes` (the stream
    follows them), its `source` in csrc/, its launch count and, where the
    wrapper gives it (K1, K6, K2's formulas), the batch size of each
    launch (`batches`: size -> launches)."""

    def __init__(self, name: str, op: str, symbol: str, source: str, argtypes):
        self.name, self.op, self.symbol = name, op, symbol
        self.source, self.argtypes = source, list(argtypes)
        self.launches = 0
        self.batches = collections.Counter()

    def __call__(self, *args, batch: int | None = None):
        fn = getattr(load(), self.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1
        if batch is not None:
            self.batches[batch] += 1

    def reset(self):
        self.launches = 0
        self.batches.clear()


def size_ranges(batches) -> dict:
    """{range label: [launches, elements]} of a batch-size histogram
    (`Kernel.batches`), by SIZE_RANGES."""
    out = {label: [0, 0] for label, _, _ in SIZE_RANGES}
    for size, count in batches.items():
        label = next(lb for lb, lo, hi in SIZE_RANGES
                     if size >= lo and (hi is None or size <= hi))
        out[label][0] += count
        out[label][1] += size * count
    return out


MONT_MUL = Kernel("mont_mul", "mont_mul", "msm_mont_mul", "mont_mul.cu",
                  [_P, _P, _P, _I64])

# K2-K5 and K9 of a curve, by op: (C symbol without "msm_" and the curve's
# prefix, source stem, argument types). Every curve's instances take the same
# arguments; only the coordinate field differs.
_CURVE_OPS = {
    "point_dadd_affine": ("xyzz_dadd_affine", "point_ops", [_P] * 11 + [_I64]),
    "point_dadd": ("xyzz_dadd", "point_ops", [_P] * 12 + [_I64]),
    "point_double": ("xyzz_double", "point_ops", [_P] * 8 + [_I64]),
    # right, local, the tails' scan, out; c, n_ch, n_buckets
    "point_bucket_diffs": ("xyzz_bucket_diffs", "point_ops",
                           [_P] * 10 + [_I32, _I64, _I64]),
    # the gap groups' sums, out; the mask of present groups, d_max
    "point_gap_horner": ("xyzz_gap_horner", "point_ops",
                         [_P] * 8 + [_I64, _I32]),
    "affine_prefix_level": ("affine_prefix_level", "scan",
                            [_P] * 8 + [_I32, _I64]),
    # K5's affine level: rows, signs, keys, buckets; n_buckets; the next
    # stream and its keys; c, n_ch
    "seg_level_affine": ("seg_level_affine", "seg",
                         [_P] * 8 + [_I64] + [_P] * 5 + [_I32, _I64]),
    # K5's segmented block scan: the stream, its keys, buckets; n_buckets;
    # scratch; n, n_tiles, k, k_carry
    "seg_scan": ("seg_scan", "seg",
                 [_P] * 9 + [_I64, _P, _I64, _I64, _I32, _I32]),
    "xyzz_fold": ("xyzz_fold", "fold", [_P] * 10 + [_I64, _I64, _I32]),
    "xyzz_prefix_scan": ("xyzz_prefix_scan", "block_scan",
                         [_P] * 9 + [_I64, _I64, _I32, _I32]),
}
# each curve's tag: G1's kernels are
# csrc/{point_ops,scan,seg,fold,block_scan}.cu, msm_*;
# G2's csrc/*_g2.cu, msm_g2_*, reported as g2_*
_CURVE_TAGS = {"G1": "", "G2": "g2"}
CURVE_KERNELS = {
    curve: {op: Kernel(f"{tag}_{op}" if tag else op, op,
                       f"msm_{tag}_{sym}" if tag else f"msm_{sym}",
                       f"{src}_{tag}.cu" if tag else f"{src}.cu", args)
            for op, (sym, src, args) in _CURVE_OPS.items()}
    for curve, tag in _CURVE_TAGS.items()
}
# K6, the SOS multiply, by stage (fields/sos.py STAGES): "full" is the
# Montgomery product, the others drivers/mxu_experiment.py's partial bodies
SOS_MUL = {stage: Kernel("sos_mul" if stage == "full" else f"sos_mul_{stage}",
                         "sos_mul", "msm_sos_mul" if stage == "full"
                         else f"msm_sos_mul_{stage}", "sos_mul.cu",
                         [_P] * 3 + [_I64])
           for stage in ("prod", "bytes", "mm1", "full")}
# K7, the chained multiply-add probe, by dtype
MADD_CHAIN = {dtype: Kernel(f"madd_chain_{dtype}", "madd_chain",
                            f"msm_madd_chain_{tag}", "madd_chain.cu",
                            [_P] * 3 + [_I64, _I64])
              for dtype, tag in (("uint32", "u32"), ("int32", "i32"),
                                 ("float32", "f32"))}
# K8, the gather from a table split over the shared memory of a 2-CTA
# cluster: table, idx, out, T, N
GATHER_SMEM = Kernel("gather_smem", "gather_smem", "msm_gather_smem",
                     "gather_smem.cu", [_P] * 3 + [_I64, _I64])
# The occupancy queries of K2, K3, K4 and K5, by op: each writes the
# resident blocks an SM of the op's kernels as built (K2's dadd_affine,
# dadd, double and bucket_diffs; K3's one; K4's tile_scan, tile_up and
# tile_down; K5's level and its scan's one-block, up, carry and down), into
# an int array of that length, from the C function msm_[<tag>_]<symbol> in
# the op's source.
OCCUPANCY = {"point_bucket_diffs": ("point_occupancy", 4),
             "affine_prefix_level": ("affine_prefix_occupancy", 1),
             "xyzz_prefix_scan": ("xyzz_prefix_scan_occupancy", 3),
             "seg_level_affine": ("seg_occupancy", 5)}


def occupancy_symbol(curve: str, op: str) -> str:
    tag = _CURVE_TAGS[curve]
    sym = OCCUPANCY[op][0]
    return f"msm_{tag}_{sym}" if tag else f"msm_{sym}"


def occupancy(curve: str, op: str) -> list:
    """The resident blocks an SM of `curve`'s kernels of `op` (a key of
    OCCUPANCY), as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports
    them for the library as built."""
    out = (ctypes.c_int * OCCUPANCY[op][1])()
    symbol = occupancy_symbol(curve, op)
    rc = getattr(load(), symbol)(out)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")
    return list(out)


def sos_occupancy() -> list:
    """The resident blocks an SM of K6's four stage kernels (prod, bytes,
    mm1, full), as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports
    them for the library as built."""
    out = (ctypes.c_int * 4)()
    rc = load().msm_sos_occupancy(out)
    if rc != 0:
        raise RuntimeError(f"msm_sos_occupancy: CUDA error {rc}")
    return list(out)


def sos_min_blocks() -> int:
    """The resident blocks an SM K6's persistent grid is sized for (and its
    launch bounds ask for), csrc/sos_mul.cu MIN_BLOCKS."""
    return load().msm_sos_min_blocks()


def point_min_blocks() -> int:
    """The resident blocks an SM that K2's wide kernels' launch bounds ask
    for (csrc/point_ops.cuh MIN_BLOCKS), from the library as built."""
    return load().msm_point_min_blocks()


ALL_KERNELS = ([MONT_MUL] + [k for ks in CURVE_KERNELS.values()
                             for k in ks.values()]
               + list(SOS_MUL.values()) + list(MADD_CHAIN.values())
               + [GATHER_SMEM])


def load():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for k in ALL_KERNELS:
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes + [_P]
            fn.restype = ctypes.c_int
        for curve in _CURVE_TAGS:
            for op in OCCUPANCY:
                fn = getattr(lib, occupancy_symbol(curve, op))
                fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
                fn.restype = ctypes.c_int
        lib.msm_point_min_blocks.argtypes = []
        lib.msm_point_min_blocks.restype = ctypes.c_int
        lib.msm_sos_occupancy.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.msm_sos_occupancy.restype = ctypes.c_int
        lib.msm_sos_min_blocks.argtypes = []
        lib.msm_sos_min_blocks.restype = ctypes.c_int
        # K8's cluster capacity (drivers/gather_bench.py cluster_capacity)
        lib.msm_gather_smem_clusters.argtypes = [
            _I64, ctypes.POINTER(ctypes.c_int)]
        lib.msm_gather_smem_clusters.restype = ctypes.c_int
        _lib = lib
    return _lib


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: a wrapper then takes its
    kernel's plain version; otherwise it launches the kernel or raises."""
    return all(t.device.type == "cpu" for t in tensors)


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def check_cuda(name: str, tensors):
    """Raise unless every tensor is a contiguous int32 CUDA tensor on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: expected torch.int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")

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
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
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
    every source in its own nvcc process, in parallel, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus, _ = _sources()
    nvcc = nvcc_path()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / (cu.stem + ".o") for cu in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(cu)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for cu, o in zip(cus, objs)]
        logs = [(cu, proc.communicate()[0], proc.returncode)
                for cu, proc in zip(cus, procs)]
        failed = [f"{cu.name} ({rc}):\n{out}" for cu, out, rc in logs if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp / so.name),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}{link.stdout}")
        so.with_suffix(".log").write_text("".join(out for _, out, _ in logs))
        os.replace(tmp / so.name, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def ptxas_summary() -> dict:
    """{kernel: "N registers, S B spill stores, L B spill loads"} from the
    build log of the current library (built first if needed)."""
    log = build().with_suffix(".log").read_text()
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(?:\S*?\d)?([a-z][a-z_]*_kernel)",
                      line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
    return out


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

_SIGNATURES = {
    "msm_mont_mul": [_P, _P, _P, _I64, _P],
    "msm_xyzz_dadd_affine": [_P] * 11 + [_I64, _P],
    "msm_xyzz_dadd": [_P] * 12 + [_I64, _P],
    "msm_xyzz_double": [_P] * 8 + [_I64, _P],
    "msm_affine_prefix_level": [_P] * 8 + [_I32, _I64, _P],
    "msm_xyzz_scan_level": [_P] * 12 + [_I32, _I64, _P],
    "msm_seg_level_affine": [_P] * 8 + [_I64] + [_P] * 10 + [_I32, _I64, _P],
    "msm_seg_level_xyzz": [_P] * 9 + [_I64] + [_P] * 10 + [_I32, _I64, _P],
}


def load():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class Kernel:
    """One kernel's C entry point with its launch count."""

    def __init__(self, symbol: str):
        assert symbol in _SIGNATURES, symbol
        self.symbol = symbol
        self.launches = 0

    def __call__(self, *args):
        fn = getattr(load(), self.symbol)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


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

"""ctypes bindings for the port's native host library (host/recode.cpp).

The library runs the host passes the reference also keeps native: the
q-ary digit split, the integral CHES conversion with its carry chain, the
BGMW95 signed recode with the r - a fold (multi_scalar.c:748-775,
auxiliaryfunc.h:83-145, main_p1.cpp:311-356), the bucket set and the digit
conversion table (auxiliaryfunc.h:257-288, main_p1.cpp:139-153). Port of
msm_blst_tpu/native.py: the same entry points, ctypes signatures and
outputs, over the port's own copy of the C++ source.

The library is built at first use, never at import: `g++ -O3 -std=c++17
-fPIC -shared -pthread` into `_build/`, named by a hash of the source and
the flags, under a file lock and written to a temporary name first, so
processes that race on the first use build it once and never load a half
written file. A build that fails raises with the compiler's message; the
numpy twins in msm/recode.py and msm/params.py run only when a caller asks
for them (`use_native=False`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .constants import R_ORDER

SOURCE = Path(__file__).parent / "host" / "recode.cpp"
BUILD_DIR = Path(__file__).parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None


def library_path() -> Path:
    """The library's path: _build/libmsm_host_<hash of source and flags>.so."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmsm_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile host/recode.cpp into the cached library (no-op when built)."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libmsm_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # another process built it while this one waited
            return so
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        try:
            r = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed ({r.returncode}) on {SOURCE}:"
                                   f"\n{r.stderr}{r.stdout}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def load() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    lib.msm_qary_digits.argtypes = [u32p, i64, i32, i32, i32p]
    lib.msm_qary_digits.restype = None
    lib.msm_ches_recode.argtypes = [
        u32p, i64, i32, i32, i32p, i32p, i32p, i32p, i32p, u8p,
    ]
    lib.msm_ches_recode.restype = ctypes.c_int
    lib.msm_bgmw_recode.argtypes = [u32p, i64, i32, i32, i32, u32p, i32p, u8p]
    lib.msm_bgmw_recode.restype = ctypes.c_int
    lib.msm_construct_bucket_set.argtypes = [i64, i64, i32p]
    lib.msm_construct_bucket_set.restype = i64
    lib.msm_digit_conversion_table.argtypes = [i64, i32p, i64, i32p, i32p, i32p]
    lib.msm_digit_conversion_table.restype = i64
    _lib = lib
    return lib


def available() -> bool:
    """True when the library is built or builds now; False when it cannot
    be (the reason: `load()`'s error)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def qary_digits(scalars_u32: np.ndarray, c: int, h: int) -> np.ndarray:
    """uint32[8, n] -> int32[h, n] standard q-ary digits."""
    lib = load()
    scalars_u32 = np.ascontiguousarray(scalars_u32, dtype=np.uint32)
    n = scalars_u32.shape[1]
    out = np.empty((h, n), dtype=np.int32)
    lib.msm_qary_digits(scalars_u32, n, c, h, out)
    return out


def ches_recode(scalars_u32: np.ndarray, c: int, h: int, m_t, b_t, a_t):
    """Integral MB-radix-q conversion. Returns (b, m, sign) [h, n]."""
    lib = load()
    scalars_u32 = np.ascontiguousarray(scalars_u32, dtype=np.uint32)
    n = scalars_u32.shape[1]
    b_out = np.empty((h, n), dtype=np.int32)
    m_out = np.empty((h, n), dtype=np.int32)
    s_out = np.empty((h, n), dtype=np.uint8)
    rc = lib.msm_ches_recode(
        scalars_u32, n, c, h,
        np.ascontiguousarray(m_t, dtype=np.int32),
        np.ascontiguousarray(b_t, dtype=np.int32),
        np.ascontiguousarray(a_t, dtype=np.int32),
        b_out, m_out, s_out,
    )
    if rc != 0:
        raise ValueError("CHES recode: leading-digit carry (invalid config)")
    return b_out, m_out, s_out.astype(bool)


_R_WORDS = np.array([(R_ORDER >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                    dtype=np.uint32)


def bgmw_recode(scalars_u32: np.ndarray, c: int, h: int, fold: bool):
    """BGMW95 signed q/2 recode (+ optional r - a fold). Returns (|digit|
    int32[h, n], sign bool[h, n])."""
    lib = load()
    scalars_u32 = np.ascontiguousarray(scalars_u32, dtype=np.uint32)
    n = scalars_u32.shape[1]
    absd = np.empty((h, n), dtype=np.int32)
    sign = np.empty((h, n), dtype=np.uint8)
    rc = lib.msm_bgmw_recode(
        scalars_u32, n, c, h, int(fold), _R_WORDS, absd, sign
    )
    if rc != 0:
        raise ValueError("BGMW recode: leading digit exceeds q/2")
    return absd, sign.astype(bool)


def construct_bucket_set(q: int, ah: int) -> np.ndarray:
    """The CHES bucket set, sorted ascending int32."""
    lib = load()
    out = np.empty(q // 2 + 2, dtype=np.int32)
    k = lib.msm_construct_bucket_set(q, ah, out)
    return out[:k].copy()


def digit_conversion_table(q: int, bucket_set: np.ndarray):
    """Returns (m_t, b_t, a_t, missing_count)."""
    lib = load()
    bucket_set = np.ascontiguousarray(bucket_set, dtype=np.int32)
    m_t = np.empty(q + 1, dtype=np.int32)
    b_t = np.empty(q + 1, dtype=np.int32)
    a_t = np.empty(q + 1, dtype=np.int32)
    missing = lib.msm_digit_conversion_table(
        q, bucket_set, len(bucket_set), m_t, b_t, a_t
    )
    return m_t, b_t, a_t, int(missing)

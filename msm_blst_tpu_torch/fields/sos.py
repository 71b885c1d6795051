"""K6: the SOS Montgomery multiply (csrc/sos_mul.cu) and its plain twin.

Replaces msm_blst_tpu/fields/pallas_mont.py sos_kernel (-> _mont_mul_body_sos,
built by make_mont_mul(impl="sos")), and the staged bodies of
drivers/mxu_experiment.py `make`. The Montgomery reduction is two products
by constants — m = (T mod R) * P' mod R with P' = -p^-1 mod R, then m * p —
each evaluated as a byte-Toeplitz matrix times byte planes. The JAX package
runs those on the TPU's matrix unit (bf16 x bf16 -> f32, exact below
2^24); K6 runs them on Hopper's integer tensor cores (u8 x u8 -> s32,
exact). The result is the canonical residue, the same words as K1's CIOS.

Stages (STAGES), each the canonical words of one integer, so a stage of
the kernel compares bit for bit with the same stage here:

* "prod":  a*b mod R (the schoolbook full product's low half);
* "bytes": the same value, rebuilt from the byte planes the reduction reads;
* "mm1":   m = (a*b*P') mod R, the first Toeplitz product;
* "full":  the Montgomery product a*b*R^-1 mod p.

The plain version follows _mont_mul_body_sos step for step over int64
16-bit limbs: the deferred-carry full product (rows < 2^22), its three
byte planes, the Toeplitz products with E and O rows fused into one matrix
each (drivers/mxu_experiment.py sos_wide), one local carry pass on m, the
carry resolve and one conditional subtract. Its matrix products run in
float64 — exact, as every product of bytes is below 2^16 and every sum of
72 of them below 2^23 — because torch has no int64 matmul on CUDA.

`sos_stage` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; `sos_mul` is its "full" stage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import P
from ..kernels import SOS_MUL, check_cuda, on_cpu, ptr
from .cuda_mont import _antidiagonal_sum
from .limb import (LIMB_BITS, MASK, LimbField, _shift_up, limbs_to_words,
                   resolve_limbs, words_to_limbs)

STAGES = ("prod", "bytes", "mm1", "full")

# plain-path batch slice: bounds the (L, L, B) int64 outer-product scratch
_PLAIN_CHUNK = 1 << 15


def build_sos_consts(L: int, modulus: int) -> dict:
    """Byte-Toeplitz reduction matrices, float32 numpy (the port's copy of
    pallas_mont.build_sos_consts).

    Column order r = s*L + l for byte s of limb l (byte position 2l+s);
    W1E/W1O rows t give byte positions 2t / 2t+1 of (x * P') mod R;
    W2E/W2O rows t give byte positions 2t / 2t+1 of (m * P).
    """
    R = 1 << (LIMB_BITS * L)
    pp = (-pow(modulus, -1, R)) % R
    nb = 2 * L
    ppb = [(pp >> (8 * i)) & 0xFF for i in range(nb)]
    pb = [(modulus >> (8 * i)) & 0xFF for i in range(nb)]

    def toeplitz(vals, out_rows, parity):
        w = np.zeros((out_rows, 3 * L), dtype=np.float32)
        for t in range(out_rows):
            for s in range(3):
                for l in range(L):
                    idx = 2 * t + parity - (2 * l + s)
                    if 0 <= idx < nb:
                        w[t, s * L + l] = vals[idx]
        return w

    return {
        "W1E": toeplitz(ppb, L, 0),
        "W1O": toeplitz(ppb, L, 1),
        "W2E": toeplitz(pb, nb, 0),
        "W2O": toeplitz(pb, nb, 1),
    }


def fused_consts(L: int, modulus: int) -> tuple:
    """sos_wide's matrices: E rows over O rows, (2L, 3L) and (4L, 3L)."""
    c = build_sos_consts(L, modulus)
    return (np.concatenate([c["W1E"], c["W1O"]]),
            np.concatenate([c["W2E"], c["W2O"]]))


# The byte Toeplitz's depth: T's 48 clean bytes, padded to 64
KERNEL_K = 64


def kernel_consts(modulus: int = P) -> np.ndarray:
    """The byte Toeplitz of K6's two products by constants, uint8[48 + 96,
    64]: the fused matrices with rows and columns in byte order. K6's full
    product resolves its carries, so the operand it multiplies is T's clean
    bytes (byte position 2l + s of limb l, planes s = 0, 1; the third plane
    of the JAX layout is zero), and row r is output byte position r: rows
    0..47 give m = T*P' mod R, rows 48..143 the 96 byte positions of m*p.
    Entry (r, k) is byte r - k of P' (resp. p). K6 builds its fragments of
    this matrix in registers from P' and p (csrc/sos.cuh lane_consts);
    tests/test_torch_sos_kernel.py reads them back against it."""
    L = 2 * (-(-modulus.bit_length() // 32))
    w1, w2 = fused_consts(L, modulus)

    def byte_order(w):
        n_pos = w.shape[0]
        rows = (w.reshape(2, n_pos // 2, 3, L).transpose(1, 0, 2, 3)
                .reshape(n_pos, 3, L))                  # row 2t + parity
        cols = rows[:, :2].transpose(0, 2, 1).reshape(n_pos, 2 * L)  # 2l + s
        out = np.zeros((n_pos, KERNEL_K), dtype=np.uint8)
        out[:, : 2 * L] = cols
        return out

    return np.concatenate([byte_order(w1), byte_order(w2)])


# ---- the plain version ----------------------------------------------------------

_FUSED: dict = {}


def _fused_on(field: LimbField, device) -> tuple:
    """fused_consts of the field as float64 on `device`, copied there once."""
    key = (field.n_limbs, field.modulus, str(device))
    t = _FUSED.get(key)
    if t is None:
        t = tuple(torch.as_tensor(w, dtype=torch.float64, device=device)
                  for w in fused_consts(field.n_limbs, field.modulus))
        _FUSED[key] = t
    return t


def _full_product(la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of clean 16-bit limbs int64[L, B] x2 ->
    deferred-carry int64[2L, B], rows < 2^22: per diagonal, the sum of the
    low halves plus the previous diagonal's high halves (_full_product)."""
    prod = la[:, None] * lb[None]                       # (L, L, B) < 2^32
    lo = _antidiagonal_sum(prod & MASK)                 # (2L-1, B)
    hi = _antidiagonal_sum(prod >> LIMB_BITS)
    zero = torch.zeros_like(lo[:1])
    return torch.cat([lo, zero]) + torch.cat([zero, hi])


def _bytes3(x: torch.Tensor) -> torch.Tensor:
    """int64[K, B] values < 2^24 -> float64[3K, B], blocks [lo8; mid8; hi8]."""
    return torch.cat([x & 0xFF, (x >> 8) & 0xFF, x >> 16]).to(torch.float64)


def _toeplitz(w: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Fused [E; O] rows times byte planes -> int64 limb sums E + (O << 8)."""
    eo = torch.matmul(w, planes).to(torch.int64)
    half = eo.shape[0] // 2
    return eo[:half] + (eo[half:] << 8)


def _mod_r(limbs: torch.Tensor, bits: int) -> torch.Tensor:
    """Non-negative limbs below 2^bits -> clean limbs of their value mod R."""
    return resolve_limbs(limbs, bits=bits)[: limbs.shape[0]]


def _sos_limbs(la: torch.Tensor, lb: torch.Tensor, field: LimbField,
               stage: str) -> torch.Tensor:
    """Clean limbs int64[L, B] x2 -> clean limbs of the stage's integer."""
    L = field.n_limbs
    w1, w2 = _fused_on(field, la.device)
    U = _full_product(la, lb)
    if stage == "prod":
        return _mod_r(U[:L], 23)
    ub = _bytes3(U[:L])                                 # (3L, B)
    if stage == "bytes":
        b = ub.to(torch.int64)
        return _mod_r(b[:L] + (b[L: 2 * L] << 8) + (b[2 * L:] << 16), 23)
    ml = _toeplitz(w1, ub)                              # (L, B) < 2^31
    if stage == "mm1":
        return _mod_r(ml, 31)
    # one local carry pass bounds m's value below 1.5 R (mod R preserved)
    m2 = (ml & MASK) + _shift_up(ml >> LIMB_BITS)
    mp = _toeplitz(w2, _bytes3(m2))                     # (2L, B) < 2^31
    # U + m p == 0 mod R; (U + m p) / R < 1.7 p
    res = resolve_limbs(U + mp, bits=33)
    return field.csub_p_limbs(res[L: 2 * L])


def sos_stage_plain(a: torch.Tensor, b: torch.Tensor, field: LimbField,
                    stage: str = "full") -> torch.Tensor:
    """Plain PyTorch SOS stage of int32[W, B] word batches."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    parts = []
    for s in range(0, max(a.shape[1], 1), _PLAIN_CHUNK):
        la = words_to_limbs(a[:, s: s + _PLAIN_CHUNK])
        lb = words_to_limbs(b[:, s: s + _PLAIN_CHUNK])
        parts.append(limbs_to_words(_sos_limbs(la, lb, field, stage)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def sos_mul_plain(a, b, field: LimbField) -> torch.Tensor:
    return sos_stage_plain(a, b, field, "full")


# ---- the kernel ----------------------------------------------------------------

def sos_stage(a: torch.Tensor, b: torch.Tensor, field: LimbField,
              stage: str = "full") -> torch.Tensor:
    """One SOS stage of int32[W, B] batches: K6 for CUDA tensors, the plain
    version for CPU tensors."""
    if on_cpu(a, b):
        return sos_stage_plain(a, b, field, stage)
    if field.modulus != P or a.shape[0] != 12:
        raise NotImplementedError("the SOS kernel is built for Fp only")
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"sos_stage: shapes {tuple(a.shape)} {tuple(b.shape)}")
    check_cuda(SOS_MUL[stage].symbol, (a, b))
    out = torch.empty_like(a)
    SOS_MUL[stage](ptr(a), ptr(b), ptr(out), a.shape[1], batch=a.shape[1])
    return out


def sos_mul(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """a*b*R^-1 mod p for int32[W, B] batches (K6's "full" stage)."""
    return sos_stage(a, b, field, "full")

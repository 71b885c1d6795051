"""K1: the batched Montgomery multiply (csrc/mont_mul.cu) and its plain twin.

Replaces msm_blst_tpu/fields/pallas_mont.py make_mont_mul (cios_kernel ->
_mont_mul_body). Every unfused `LimbField.mul` of the port lands here,
batch inversion, `pow_int` and the xyzz -> Jacobian/affine conversions
included.

`mont_mul` launches the kernel for CUDA tensors and takes `mont_mul_plain`
only for CPU tensors. The plain version computes the same canonical residue
with int64 tensor ops over 16-bit limbs: the full product as one outer
product summed along its anti-diagonals, then Montgomery reduction with the
full-width constant -p^-1 mod R. Any exact method gives the same words.
"""

from __future__ import annotations

import torch

from ..constants import P
from ..kernels import MONT_MUL, check_cuda, on_cpu, ptr
from .limb import (LIMB_BITS, LimbField, limbs_to_words, resolve_limbs,
                   words_to_limbs)

# plain-path batch slice: bounds the (L, 2L, B) int64 outer-product scratch
_PLAIN_CHUNK = 1 << 15


def _antidiagonal_sum(prod: torch.Tensor) -> torch.Tensor:
    """prod[i, j, *b] -> out[k, *b] = sum over i + j == k, k < 2L - 1."""
    L = prod.shape[0]
    rest = prod.shape[2:]
    padded = torch.cat([prod, torch.zeros_like(prod)], dim=1)  # (L, 2L, *b)
    flat = padded.reshape((2 * L * L,) + rest)[: L * (2 * L - 1)]
    return flat.reshape((L, 2 * L - 1) + rest).sum(dim=0)


def _mont_mul_limbs(la: torch.Tensor, lb: torch.Tensor,
                    field: LimbField) -> torch.Tensor:
    """Clean limbs int64[L, B] x2 -> canonical a*b*R^-1 mod p limbs."""
    L = field.n_limbs
    zero = torch.zeros_like(la[:1])
    # limbs of T = a*b: sums of L products of 16-bit limbs, < 2^37
    T = torch.cat([_antidiagonal_sum(la[:, None] * lb[None]), zero])
    # m = (T mod R) * (-p^-1) mod R; products < 2^53, sums < 2^58
    nprime = field.limb_const("NPRIME", la.device, 1)[None]  # (1, L, 1)
    m = _antidiagonal_sum(T[:L, None] * nprime)[:L]
    m = resolve_limbs(m, bits=58)[:L]
    # T + m*p == 0 mod R; (T + m*p) / R < 2p
    prime = field.limb_const("P", la.device, 1)[None]
    U = T + torch.cat([_antidiagonal_sum(m[:, None] * prime), zero])
    r = resolve_limbs(U, bits=2 * LIMB_BITS + 7)[L: 2 * L]
    return field.csub_p_limbs(r)


def mont_mul_plain(a: torch.Tensor, b: torch.Tensor,
                   field: LimbField) -> torch.Tensor:
    """Plain PyTorch Montgomery product of int32[W, B] word batches."""
    parts = []
    for s in range(0, max(a.shape[1], 1), _PLAIN_CHUNK):
        la = words_to_limbs(a[:, s: s + _PLAIN_CHUNK])
        lb = words_to_limbs(b[:, s: s + _PLAIN_CHUNK])
        parts.append(limbs_to_words(_mont_mul_limbs(la, lb, field)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def mont_mul(a: torch.Tensor, b: torch.Tensor,
             field: LimbField) -> torch.Tensor:
    """a*b*R^-1 mod p for int32[W, B] batches: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if on_cpu(a, b):
        return mont_mul_plain(a, b, field)
    if field.modulus != P or a.shape[0] != 12:
        raise NotImplementedError("the CUDA multiply is built for Fp only")
    if a.ndim != 2 or a.shape != b.shape:
        raise ValueError(f"mont_mul: shapes {tuple(a.shape)} {tuple(b.shape)}")
    check_cuda("mont_mul", (a, b))
    out = torch.empty_like(a)
    MONT_MUL(ptr(a), ptr(b), ptr(out), a.shape[1], batch=a.shape[1])
    return out

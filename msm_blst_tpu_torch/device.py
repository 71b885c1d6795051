"""The device the port's entry points use when the caller names none: the
CUDA card. There is no fallback to the CPU; a caller who wants the CPU
(the tests, the plain versions) passes `device="cpu"`."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """torch.device("cuda"); raises RuntimeError when torch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "msm_blst_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """`device` as a torch.device, or default_device() when it is None."""
    return default_device() if device is None else torch.device(device)

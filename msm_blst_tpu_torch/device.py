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


# The share of the free device memory a step may plan to take: the rest is
# left to the allocator's rounding and fragmentation and to what the step
# does not count.
FREE_SHARE = 0.5


def budget_bytes(device) -> int:
    """The bytes a step may take on the CUDA `device` now: FREE_SHARE of
    the card's free memory (torch.cuda.mem_get_info) and of what PyTorch's
    caching allocator holds reserved but unused."""
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int(FREE_SHARE * (free + cached))

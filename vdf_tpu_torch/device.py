"""Where the port's entry points put their tensors.

Every constructor that takes ``device=None`` resolves it here: the first
CUDA card, or ``KernelError`` where there is none.  The CPU is never a
default; a caller that wants it (the CPU tests do) names the CPU as its device.
"""

from __future__ import annotations

import torch

from .errors import KernelError


def default_device() -> torch.device:
    """``cuda:0``; raises KernelError where no CUDA device is available."""
    if not torch.cuda.is_available():
        raise KernelError(
            "no CUDA device: torch.cuda.is_available() is False; pass device=\"cpu\" to run "
            "the plain versions on the CPU"
        )
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means ``default_device()``."""
    return default_device() if device is None else torch.device(device)

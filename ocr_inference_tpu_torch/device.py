"""Device resolution for the port's entry points, and device faults.

Entry points run on the card unless the caller asks for the CPU. There is
no silent fallback: asking for (or defaulting to) CUDA on a machine without
a card raises. A CUDA error is a fault of the card, not of a page: the
pipelines raise it instead of failing the page.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


class DeviceFault(RuntimeError):
    """A CUDA error. CUDA errors are sticky: every later call on the
    context fails too, so a fault ends a run instead of failing one page."""


def is_device_fault(exc: BaseException) -> bool:
    """True for an error raised by the card rather than by a page: the
    port's own kernel launch errors, PyTorch's ``AcceleratorError`` and
    the CUDA errors older PyTorch raises as ``RuntimeError``."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(exc, DeviceFault) or (accel and isinstance(exc, accel)):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)

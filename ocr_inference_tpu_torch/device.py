"""Device resolution for the port's entry points, device faults, and
copies between the host and the card.

Entry points run on the card unless the caller asks for the CPU. There is
no silent fallback: asking for (or defaulting to) CUDA on a machine without
a card raises. A CUDA error is a fault of the card, not of a page: the
pipelines raise it instead of failing the page.

Copies between host and card never wait for other work: uploads are staged
in pinned memory and copied with ``non_blocking=True``; results come back
the same way, with a CUDA event that their reader waits on. PyTorch's
caching host allocator is the staging pool: it hands a pinned block out
again only after the copies recorded on it have completed.
"""

from __future__ import annotations

import numpy as np
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


def host_buffer(shape, device: torch.device) -> torch.Tensor:
    """An uninitialized uint8 host tensor to stage an upload to ``device``
    in: pinned when the upload goes to the card."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint8 host array of any strides -> a tensor on ``device``, copied
    through a staging buffer (one host copy) without waiting for the card."""
    staging = host_buffer(array.shape, device)
    np.copyto(staging.numpy(), array)
    return staging.to(device, non_blocking=True)


class PendingHost:
    """Device tensors' copies to the host, queued when this is made;
    ``get`` waits for those copies alone (one event recorded right after
    them), not for the work queued later on the card."""

    def __init__(self, *tensors: torch.Tensor):
        dev = tensors[0].device
        if dev.type != "cuda":
            self._host, self._event = tensors, None
            return
        self._host = []
        for t in tensors:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._host.append(host)
        # a blocking event yields the waiting thread's core while it waits
        self._event = torch.cuda.Event(blocking=True)
        self._event.record(torch.cuda.current_stream(dev))

    def get(self):
        """The array, or a tuple of arrays when several tensors were given;
        on the CPU they share memory with the tensors."""
        if self._event is not None:
            self._event.synchronize()
        arrays = tuple(t.numpy() for t in self._host)
        return arrays[0] if len(arrays) == 1 else arrays

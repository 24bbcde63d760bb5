"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no silent fallback: asking for (or defaulting to) CUDA on a machine without
a card raises.
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

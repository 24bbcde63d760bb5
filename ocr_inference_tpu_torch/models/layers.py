"""Building blocks, counterpart of ocr_inference_tpu/models/layers.py.

Submodules carry the Flax module names (``Conv_0``, ``BatchNorm_0``,
``Dense_1``, ...) so a Flax checkpoint's parameter paths map one to one
onto ``state_dict`` keys (models/params.py ``params_from_flax``). Tensors
are channels-first (NCHW, or NCL for the 1-D recognizer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5  # flax.linen.BatchNorm's default (onnx/transplant.py:412-414)


def same_pads(length: int, k: int, stride: int = 1, dilation: int = 1):
    """XLA SAME padding (lo, hi) for an input of ``length``."""
    k_eff = (k - 1) * dilation + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + k_eff - length, 0)
    return total // 2, total - total // 2


class ConvBN(nn.Module):
    """3x3 stride-1 SAME Conv2d (no bias) + BatchNorm + optional ReLU
    (layers.py ConvBN at its UNet settings)."""

    def __init__(self, cin: int, cout: int, act: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=BN_EPS)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class ConvBN1D(nn.Module):
    """Conv1d (no bias) + BatchNorm + optional ReLU with XLA SAME padding
    computed per input width, so every width bucket (512..3000) pads as
    Flax does (layers.py ConvBN1D)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv1d(cin, cout, k, stride=stride, dilation=dilation,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(cout, eps=BN_EPS)
        self.k, self.stride, self.dilation, self.act = k, stride, dilation, act

    def forward(self, x):
        x = F.pad(x, same_pads(x.shape[-1], self.k, self.stride, self.dilation))
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class SqueezeExcite1D(nn.Module):
    """Squeeze-and-excitation over (B, C, T) (layers.py SqueezeExcite1D)."""

    def __init__(self, features: int):
        super().__init__()
        hidden = max(features // 8, 8)
        self.Dense_0 = nn.Linear(features, hidden)
        self.Dense_1 = nn.Linear(hidden, features)

    def forward(self, x):
        s = x.mean(dim=2)
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
        return x * s[:, :, None]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of NCHW (layers.py:144-148)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """NCHW space-to-depth in Flax's channel order: output channel
    ``(bi * block + bj) * C + c`` (segmentation.py:31-36; torch's
    pixel_unshuffle uses the c-major order and does not match)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * block * block, h // block, w // block)

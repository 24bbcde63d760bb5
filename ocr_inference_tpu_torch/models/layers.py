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
BN_MOMENTUM = 0.99  # flax.linen.BatchNorm's running-average decay


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the channel axis of (B, C, ...) with Flax's
    semantics.

    In eval mode it is ``nn.BatchNorm`` on the running statistics. In
    train mode it computes as ``flax.linen.BatchNorm(use_running_average=
    False)``: the batch mean and the biased variance in float32 over every
    axis but the channel, the variance as ``max(0, E[x^2] - E[x]^2)``,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32 cast back
    to the input's dtype, and the running statistics updated in place as
    ``0.99 * running + 0.01 * batch`` (torch's BatchNorm uses the unbiased
    variance and momentum 0.1)."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS)

    def _check_input_dim(self, x):
        if x.ndim < 2:
            raise ValueError(f"expected (B, C, ...) input, got {x.ndim}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        axes = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(axes)
        var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.copy_(BN_MOMENTUM * self.running_mean
                                    + (1 - BN_MOMENTUM) * mean)
            self.running_var.copy_(BN_MOMENTUM * self.running_var
                                   + (1 - BN_MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean.view(shape)) * mul.view(shape) + \
            self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


def float_head(head: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A model's head in its own dtype (float32, as Flax's heads take
    ``dtype=float32`` whatever the body's), outside any autocast
    region."""
    with torch.autocast(x.device.type, enabled=False):
        return head(x.to(head.weight.dtype))


def same_pads(length: int, k: int, stride: int = 1, dilation: int = 1):
    """XLA SAME padding (lo, hi) for an input of ``length``."""
    k_eff = (k - 1) * dilation + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + k_eff - length, 0)
    return total // 2, total - total // 2


def pad_same_2d(x: torch.Tensor, k: int, stride: int = 1, dilation: int = 1,
                value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's SAME does for its height and width: the
    larger half after (a stride-2 3x3 over 512 pads (0, 1), a stride-2 7x7
    (2, 3)), which a symmetric ``padding=`` cannot express."""
    top, bottom = same_pads(x.shape[-2], k, stride, dilation)
    left, right = same_pads(x.shape[-1], k, stride, dilation)
    return F.pad(x, (left, right, top, bottom), value=value)


class ConvBN(nn.Module):
    """Square Conv2d (no bias) with XLA SAME padding + BatchNorm + optional
    ReLU (layers.py ConvBN). At stride 1 with an odd effective kernel the
    SAME padding is symmetric and the convolution pads itself; otherwise
    it is computed per input size and padded explicitly."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__()
        k_eff = (kernel - 1) * dilation + 1
        self.own_pad = stride == 1 and k_eff % 2 == 1
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride=stride,
                                dilation=dilation, bias=False,
                                padding=(k_eff - 1) // 2 if self.own_pad else 0)
        self.BatchNorm_0 = BatchNorm(cout)
        self.kernel, self.stride, self.dilation, self.act = (
            kernel, stride, dilation, act)

    def forward(self, x):
        if not self.own_pad:
            x = pad_same_2d(x, self.kernel, self.stride, self.dilation)
        x = self.BatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.act else x


class ResidualBlock(nn.Module):
    """ResNet basic block: two 3x3 ConvBN, the second without ReLU, plus
    the input, or its 1x1 strided projection with its BatchNorm where the
    shape changes (layers.py ResidualBlock), then ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, features, stride=stride)
        self.ConvBN_1 = ConvBN(features, features, act=False)
        self.project = stride != 1 or cin != features
        if self.project:
            # a 1x1 kernel needs no SAME padding at any stride
            self.Conv_0 = nn.Conv2d(cin, features, 1, stride=stride,
                                    bias=False)
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        y = self.ConvBN_1(self.ConvBN_0(x))
        residual = self.BatchNorm_0(self.Conv_0(x)) if self.project else x
        return F.relu(y + residual)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (layers.py ASPP): a 1x1 branch, 3x3
    branches at each rate, the image-pool branch (mean over H, W, a 1x1
    ConvBN on the 1x1 map, broadcast back), concatenated in that order and
    projected by a 1x1 ConvBN."""

    def __init__(self, cin: int, features: int = 256,
                 rates: tuple[int, ...] = (6, 12, 18)):
        super().__init__()
        branches = [ConvBN(cin, features, 1)]
        branches += [ConvBN(cin, features, 3, dilation=r) for r in rates]
        branches.append(ConvBN(cin, features, 1))  # image pool
        branches.append(ConvBN(features * len(branches), features, 1))
        for i, m in enumerate(branches):
            self.add_module(f"ConvBN_{i}", m)
        self.n_rates = len(rates)

    def forward(self, x):
        convs = [getattr(self, f"ConvBN_{i}") for i in range(self.n_rates + 3)]
        branches = [m(x) for m in convs[: self.n_rates + 1]]
        pooled = convs[-2](x.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return convs[-1](torch.cat(branches, dim=1))


def resize_feature(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear NCHW resize to (h, w) (layers.py resize_feature). For the
    upsamplings DeepLabV3+ makes, ``jax.image.resize(..., "bilinear")``
    (half-pixel centres, a triangle kernel renormalised at the borders)
    is the same function as align_corners=False bilinear with clamped
    borders; tests/test_torch_layout.py holds the two together."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)


class ConvBN1D(nn.Module):
    """Conv1d (no bias) + BatchNorm + optional ReLU with XLA SAME padding
    computed per input width, so every width bucket (512..3000) pads as
    Flax does (layers.py ConvBN1D)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv1d(cin, cout, k, stride=stride, dilation=dilation,
                                bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
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

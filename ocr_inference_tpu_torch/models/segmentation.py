"""Segmentation networks, counterpart of
ocr_inference_tpu/models/segmentation.py: the line UNet (:39-100) and the
layout DeepLabV3+ with its ResNet encoder (:102-147).

Input NCHW float in [0, 1]; output NCHW logits (no sigmoid or softmax).
The body runs in the module's dtype (bf16 by default, as the Flax modules);
the 1x1 head runs in float32 on a float32 copy of the features, as Flax's
head does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_inference_tpu_torch.models.layers import (
    ASPP,
    ConvBN,
    ResidualBlock,
    float_head,
    pad_same_2d,
    resize_feature,
    space_to_depth,
    upsample2x,
)


class UNet(nn.Module):
    """Four down/up levels with concat skips; ``stem_stride=2`` adds the
    space-to-depth stem (full-resolution ConvBN -> regroup to 1/2 scale)
    and the full-resolution refinement ConvBN after the decoder.

    Flax creation order gives the names: ConvBN_0 is the stem (stride 2),
    then two per encoder level, two at the bottom, two per decoder level
    and the refinement last; Conv_0..3 are the decoder's 2x2 up-convs and
    the last Conv_ is the head.
    """

    def __init__(self, classes: int = 1, width: int = 32, stem_stride: int = 1,
                 in_ch: int = 3):
        super().__init__()
        w = width
        feats = [w, w * 2, w * 4, w * 8]
        self.stem_stride = stem_stride
        convbn: list[ConvBN] = []
        cin = in_ch
        if stem_stride > 1:
            convbn.append(ConvBN(in_ch, w // 2))
            cin = in_ch * stem_stride * stem_stride
        for f in feats:
            convbn += [ConvBN(cin, f), ConvBN(f, f)]
            cin = f
        convbn += [ConvBN(cin, w * 16), ConvBN(w * 16, w * 16)]
        cin = w * 16
        ups = []
        for f in reversed(feats):
            ups.append(nn.Conv2d(cin, f, 2, bias=True))
            convbn += [ConvBN(f + f, f), ConvBN(f, f)]
            cin = f
        head_in = feats[0]
        if stem_stride > 1:
            convbn.append(ConvBN(feats[0] + w // 2, w // 2))
            head_in = w // 2
        for i, m in enumerate(convbn):
            self.add_module(f"ConvBN_{i}", m)
        for i, m in enumerate(ups):
            self.add_module(f"Conv_{i}", m)
        self.add_module(f"Conv_{len(ups)}", nn.Conv2d(head_in, classes, 1))
        self._convbn, self._ups = convbn, ups
        self._head_name = f"Conv_{len(ups)}"

    def body_dtype(self) -> torch.dtype:
        return self.ConvBN_0.Conv_0.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.body_dtype())
        cb = iter(self._convbn)

        def two(t):
            first = next(cb)
            return next(cb)(first(t))

        stem = None
        if self.stem_stride > 1:
            stem = next(cb)(x)
            x = space_to_depth(x, self.stem_stride)
        skips = []
        for _ in range(4):
            x = two(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = two(x)
        for up, skip in zip(self._ups, reversed(skips)):
            x = up(F.pad(upsample2x(x), (0, 1, 0, 1)))  # SAME (0, 1)
            x = two(torch.cat([x, skip], dim=1))
        if stem is not None:
            s = self.stem_stride
            while s > 1:
                x = upsample2x(x)
                s //= 2
            x = next(cb)(torch.cat([x, stem], dim=1))
        return float_head(getattr(self, self._head_name), x)


class ResNetEncoder(nn.Module):
    """ResNet encoder (segmentation.py:102-123): a 7x7 stride-2 ConvBN stem,
    a 3x3 stride-2 SAME max pool (padded with -inf, the larger half after),
    then ``blocks_per_stage`` ResidualBlocks a stage, every stage after the
    first opening with a stride-2 block. Returns (stride-4 ``low``,
    stride-32 ``high``)."""

    def __init__(self, widths: tuple[int, ...] = (64, 128, 256, 512),
                 blocks_per_stage: int = 2, in_ch: int = 3):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, widths[0], 7, stride=2)
        blocks = [ResidualBlock(widths[0], widths[0])
                  for _ in range(blocks_per_stage)]
        self.low_blocks = blocks_per_stage
        cin = widths[0]
        for f in widths[1:]:
            blocks.append(ResidualBlock(cin, f, stride=2))
            blocks += [ResidualBlock(f, f) for _ in range(blocks_per_stage - 1)]
            cin = f
        for i, m in enumerate(blocks):
            self.add_module(f"ResidualBlock_{i}", m)
        self._blocks = blocks

    def forward(self, x):
        x = self.ConvBN_0(x)
        x = F.max_pool2d(pad_same_2d(x, 3, 2, value=float("-inf")), 3, 2)
        low = None
        for i, block in enumerate(self._blocks):
            x = block(x)
            if i == self.low_blocks - 1:
                low = x
        return low, x


class DeepLabV3Plus(nn.Module):
    """DeepLabV3+ for multi-class layout segmentation
    (segmentation.py:126-147): ASPP (256) on the stride-32 features,
    upsampled to the stride-4 ``low`` map and concatenated before a 1x1
    48-channel projection of ``low``, two 3x3 256-channel ConvBN, the
    float32 1x1 head, and a bilinear resize of the logits to the input
    size."""

    _head_name = "Conv_0"

    def __init__(self, classes: int = 5, in_ch: int = 3):
        super().__init__()
        self.ResNetEncoder_0 = ResNetEncoder(in_ch=in_ch)
        self.ASPP_0 = ASPP(512, 256)
        self.ConvBN_0 = ConvBN(64, 48, 1)
        self.ConvBN_1 = ConvBN(256 + 48, 256)
        self.ConvBN_2 = ConvBN(256, 256)
        self.Conv_0 = nn.Conv2d(256, classes, 1)

    def body_dtype(self) -> torch.dtype:
        return self.ResNetEncoder_0.ConvBN_0.Conv_0.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        x = x.to(self.body_dtype())
        low, high = self.ResNetEncoder_0(x)
        y = resize_feature(self.ASPP_0(high), low.shape[2], low.shape[3])
        y = torch.cat([y, self.ConvBN_0(low)], dim=1)
        y = self.ConvBN_2(self.ConvBN_1(y))
        return resize_feature(float_head(self.Conv_0, y), h, w)

"""Line segmentation UNet, counterpart of
ocr_inference_tpu/models/segmentation.py:39-100.

Input NCHW float in [0, 1]; output NCHW logits (no sigmoid). The body runs
in the module's dtype (bf16 by default, as the Flax module); the 1x1 head
runs in float32 on a float32 copy of the features, as Flax's head does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_inference_tpu_torch.models.layers import ConvBN, space_to_depth, upsample2x


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
        return getattr(self, self._head_name)(x.float())

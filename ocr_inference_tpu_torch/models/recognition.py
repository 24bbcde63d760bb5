"""Easter2 line recognizer (base variant), counterpart of
ocr_inference_tpu/models/recognition.py:30-153.

Input (B, H, W) float in [-1, 1]: width is the time axis and height the
channels, so the net is 1-D convs over (B, H, W) read as (B, C, L). Total
stride 4 gives T = ceil(W / 4) steps; output (B, T, V) float32 logits with
the CTC blank at index 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_inference_tpu_torch.models.layers import BN_EPS, ConvBN1D, SqueezeExcite1D


class Easter2Block(nn.Module):
    """Three ConvBN1D with a 1x1-conv+BN residual and squeeze-excite gating
    (recognition.py Easter2Block)."""

    def __init__(self, cin: int, cout: int, k: int, repeats: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv1d(cin, cout, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(cout, eps=BN_EPS)
        convs = []
        for i in range(repeats):
            convs.append(ConvBN1D(cin if i == 0 else cout, cout, k,
                                  act=i < repeats - 1))
            self.add_module(f"ConvBN1D_{i}", convs[-1])
        self._convs = convs
        self.SqueezeExcite1D_0 = SqueezeExcite1D(cout)

    def forward(self, x):
        residual = self.BatchNorm_0(self.Conv_0(x))
        y = x
        for conv in self._convs:
            y = conv(y)
        y = self.SqueezeExcite1D_0(y)
        return F.relu(y + residual)


class Easter2(nn.Module):
    """Easter2 base: two stride-2 stems, three blocks, a dilated post conv,
    a 1x1 post conv and a float32 vocab head."""

    _head_name = "Conv_0"

    def __init__(self, vocab_size: int, input_height: int = 80,
                 stem_features: int = 128, width_mult: float = 1.0):
        super().__init__()
        w256 = max(int(256 * width_mult), 8)
        w512 = max(int(512 * width_mult), 8)
        self.ConvBN1D_0 = ConvBN1D(input_height, stem_features, 3, stride=2)
        self.ConvBN1D_1 = ConvBN1D(stem_features, stem_features, 3, stride=2)
        self.Easter2Block_0 = Easter2Block(stem_features, w256, 5)
        self.Easter2Block_1 = Easter2Block(w256, w256, 7)
        self.Easter2Block_2 = Easter2Block(w256, w512, 9)
        self.ConvBN1D_2 = ConvBN1D(w512, w512, 11, dilation=2)
        self.ConvBN1D_3 = ConvBN1D(w512, w512, 1)
        self.Conv_0 = nn.Conv1d(w512, vocab_size, 1, bias=True)

    def body_dtype(self) -> torch.dtype:
        return self.ConvBN1D_0.Conv_0.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.body_dtype())
        x = self.ConvBN1D_1(self.ConvBN1D_0(x))
        x = self.Easter2Block_2(self.Easter2Block_1(self.Easter2Block_0(x)))
        x = self.ConvBN1D_3(self.ConvBN1D_2(x))
        return self.Conv_0(x.float()).transpose(1, 2)  # (B, T, V)

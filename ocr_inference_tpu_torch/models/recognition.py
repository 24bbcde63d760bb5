"""Line recognizers, counterpart of ocr_inference_tpu/models/recognition.py:
the Easter2 family (base, attention, vit) and CRNN, with the factory
``build_recognizer`` keyed by the reference architecture names.

Input (B, H, W) float in [-1, 1]; output (B, T, V) float32 logits with the
CTC blank at index 0, T = W / 4 for the bucket widths (multiples of 4).

- Easter2 reads width as the time axis and height as the channels: 1-D
  convs over (B, H, W) read as (B, C, L), total stride 4. The attention
  variants put 2 (attention) or 4 (vit) pre-norm self-attention blocks
  after the conv trunk; they run on (B, T, C), and every frame of the
  bucket attends, padding included, as in the Flax module.
- CRNN collapses the height with five 3x3 conv+BN+ReLU stages and VALID
  max pools, then two bidirectional GRU layers over the width.

Submodules carry the Flax module names so ``params_from_flax`` maps a
checkpoint one to one. The attention is plain tensor ops (the JAX package
computes it in XLA, outside any Pallas kernel); the GRU is ``nn.GRU``,
cuDNN's RNN on the card, for the ``lax.scan`` of the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ocr_inference_tpu_torch.models.layers import (
    BatchNorm,
    ConvBN1D,
    SqueezeExcite1D,
    float_head,
)

# flax.linen.LayerNorm's default epsilon (MHSABlock.ln_eps); torch's is 1e-5
LN_EPS = 1e-6


class Easter2Block(nn.Module):
    """Three ConvBN1D with a 1x1-conv+BN residual and squeeze-excite gating
    (recognition.py Easter2Block)."""

    def __init__(self, cin: int, cout: int, k: int, repeats: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv1d(cin, cout, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
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


class MultiHeadDotProductAttention(nn.Module):
    """Self-attention as flax.linen.MultiHeadDotProductAttention computes
    it: per-head projections (Flax kernels (C, heads, d) and (heads, d, C),
    held here as Linear weights split heads-major), the query divided by
    sqrt(d) before the product, softmax over the keys in the module dtype,
    and the output projection. In bf16 torch's softmax accumulates in
    float32 where Flax's runs in bf16; that difference is held only by
    tolerances."""

    def __init__(self, features: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(features, features)
        self.key = nn.Linear(features, features)
        self.value = nn.Linear(features, features)
        self.out = nn.Linear(features, features)

    def forward(self, x):  # (B, T, C)
        b, t, c = x.shape
        d = c // self.heads

        def split(proj):  # (B, T, C) -> (B, heads, T, d)
            return proj(x).view(b, t, self.heads, d).transpose(1, 2)

        q = split(self.query) / math.sqrt(d)
        weights = torch.softmax(q @ split(self.key).transpose(-1, -2), dim=-1)
        y = (weights @ split(self.value)).transpose(1, 2).reshape(b, t, c)
        return self.out(y)


class MHSABlock(nn.Module):
    """Pre-norm self-attention + MLP over (B, T, C) (recognition.py
    MHSABlock): LayerNorm (eps 1e-6), attention, residual; LayerNorm,
    Dense C -> 4C, tanh-approximated GELU (Flax's ``nn.gelu`` default),
    Dense 4C -> C, residual."""

    def __init__(self, features: int, heads: int = 8):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(features, eps=LN_EPS)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            features, heads)
        self.LayerNorm_1 = nn.LayerNorm(features, eps=LN_EPS)
        self.Dense_0 = nn.Linear(features, 4 * features)
        self.Dense_1 = nn.Linear(4 * features, features)

    def forward(self, x):
        x = x + self.MultiHeadDotProductAttention_0(self.LayerNorm_0(x))
        y = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(y)


class Easter2(nn.Module):
    """Easter2: two stride-2 stems, three blocks, for ``variant``
    "attention" 2 and for "vit" 4 MHSA blocks, a dilated post conv, a 1x1
    post conv and a float32 vocab head."""

    _head_name = "Conv_0"
    DEPTHS = {"base": 0, "attention": 2, "vit": 4}

    def __init__(self, vocab_size: int, input_height: int = 80,
                 stem_features: int = 128, width_mult: float = 1.0,
                 variant: str = "base"):
        super().__init__()
        if variant not in self.DEPTHS:
            raise ValueError(f"unknown Easter2 variant {variant!r}")
        w256 = max(int(256 * width_mult), 8)
        w512 = max(int(512 * width_mult), 8)
        self.ConvBN1D_0 = ConvBN1D(input_height, stem_features, 3, stride=2)
        self.ConvBN1D_1 = ConvBN1D(stem_features, stem_features, 3, stride=2)
        self.Easter2Block_0 = Easter2Block(stem_features, w256, 5)
        self.Easter2Block_1 = Easter2Block(w256, w256, 7)
        self.Easter2Block_2 = Easter2Block(w256, w512, 9)
        self._attention = []
        for i in range(self.DEPTHS[variant]):
            self._attention.append(MHSABlock(w512))
            self.add_module(f"MHSABlock_{i}", self._attention[-1])
        self.ConvBN1D_2 = ConvBN1D(w512, w512, 11, dilation=2)
        self.ConvBN1D_3 = ConvBN1D(w512, w512, 1)
        self.Conv_0 = nn.Conv1d(w512, vocab_size, 1, bias=True)

    def body_dtype(self) -> torch.dtype:
        return self.ConvBN1D_0.Conv_0.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.body_dtype())
        x = self.ConvBN1D_1(self.ConvBN1D_0(x))
        x = self.Easter2Block_2(self.Easter2Block_1(self.Easter2Block_0(x)))
        if self._attention:
            x = x.transpose(1, 2)  # (B, C, T) -> (B, T, C)
            for block in self._attention:
                x = block(x)
            x = x.transpose(1, 2)
        x = self.ConvBN1D_3(self.ConvBN1D_2(x))
        return float_head(self.Conv_0, x).transpose(1, 2)  # (B, T, V)


class CRNN(nn.Module):
    """CNN + two bidirectional GRU layers (recognition.py CRNN): 3x3 convs
    without bias (SAME), BatchNorm, ReLU and VALID max pools of (2, 2),
    (2, 2), (2, 1), (2, 1), none; the remaining (H/16, C) of each column
    flattened height-major (feature h * 512 + c, as the Flax module's NHWC
    transpose gives), Dense to ``hidden``, the BiGRU, a float32 head.

    ``BiGRU`` holds the four Flax cells: GRUCell_0/1 are layer 0 forward
    and backward, GRUCell_2/3 layer 1 (``params_from_flax``). The GRU runs
    in the body's dtype."""

    _head_name = "Dense_1"
    STAGES = ((64, (2, 2)), (128, (2, 2)), (256, (2, 1)), (256, (2, 1)),
              (512, None))

    def __init__(self, vocab_size: int, input_height: int = 80,
                 hidden: int = 256):
        super().__init__()
        cin, h = 1, input_height
        self._pools = []
        for i, (cout, pool) in enumerate(self.STAGES):
            self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, 3, padding=1,
                                                   bias=False))
            self.add_module(f"BatchNorm_{i}", BatchNorm(cout))
            self._pools.append(pool)
            cin = cout
            if pool is not None:
                h //= pool[0]
        self.Dense_0 = nn.Linear(h * cin, hidden)
        self.BiGRU = nn.GRU(hidden, hidden, num_layers=2, batch_first=True,
                            bidirectional=True)
        self.Dense_1 = nn.Linear(2 * hidden, vocab_size)

    def body_dtype(self) -> torch.dtype:
        return self.Conv_0.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.body_dtype())[:, None]  # (B, 1, H, W)
        for i, pool in enumerate(self._pools):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(x))
            x = F.relu(x)
            if pool is not None:
                x = F.max_pool2d(x, pool, stride=pool)
        b, c, h, w = x.shape
        x = self.Dense_0(x.permute(0, 3, 2, 1).reshape(b, w, h * c))
        x, _ = self.BiGRU(x)
        return float_head(self.Dense_1, x)  # (B, W / 4, V)


def build_recognizer(architecture: str, vocab_size: int,
                     input_height: int = 80, **kwargs) -> nn.Module:
    """The recognizer for a reference architecture name, case-insensitive
    (recognition.py:213-230): Easter2 / Easter2b (base), Easter2-Attention,
    Easter2-Vit, CRNN. ``kwargs`` pass through to the module
    (``width_mult``/``stem_features`` for Easter2, ``hidden`` for CRNN)."""
    arch = architecture.lower()
    if arch in ("easter2", "easter2b"):
        return Easter2(vocab_size, input_height, **kwargs)
    if arch == "easter2-attention":
        return Easter2(vocab_size, input_height, variant="attention", **kwargs)
    if arch == "easter2-vit":
        return Easter2(vocab_size, input_height, variant="vit", **kwargs)
    if arch == "crnn":
        return CRNN(vocab_size, input_height, **kwargs)
    raise ValueError(f"Unknown recognizer architecture: {architecture}")

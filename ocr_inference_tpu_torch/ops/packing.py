"""Bit-packed binary masks, counterpart of ocr_inference_tpu/ops/packing.py.

The detection mask is 1 bit per pixel; it leaves the card packed into int32
words, 32x fewer bytes than uint8 (``pack_mask`` on the card,
``unpack_mask`` on the host). The other direction packs a binary image on
the host (``pack_bits_host``) and unpacks it on the card
(``unpack_bits_device``). The layout is the JAX package's: np.unpackbits
bit order within each byte (first pixel in the high bit), bytes packed
little-endian into int32 words, so a mask packed by either package or
either packer unpacks with either unpacker.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """(..., W) bool/0-1 tensor -> (..., ceil(ceil(W/8)/4)) int32."""
    bits = mask.to(torch.bool).to(torch.uint8)
    w = bits.shape[-1]
    n_words = -(-(-(-w // 8)) // 4)
    pad = n_words * 32 - w
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (n_words * 4, 8)).to(torch.int32)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    as_bytes = (bits << shifts).sum(dim=-1)  # (..., n_words * 4), 0..255
    grouped = as_bytes.reshape(as_bytes.shape[:-1] + (n_words, 4))
    word = (
        grouped[..., 0]
        | (grouped[..., 1] << 8)
        | (grouped[..., 2] << 16)
        | (grouped[..., 3] << 24)
    )
    return word.to(torch.int32)


def unpack_mask(packed_host: np.ndarray, width: int) -> np.ndarray:
    """Inverse of pack_mask on the host: (..., n32) int32 -> (..., width)
    uint8 with values 0/1."""
    arr = np.ascontiguousarray(packed_host, dtype=np.int32)
    as_bytes = arr.view(np.uint8).reshape(arr.shape[:-1] + (arr.shape[-1] * 4,))
    bits = np.unpackbits(as_bytes, axis=-1)
    return bits[..., :width]


def pack_bits_host(bits: np.ndarray) -> np.ndarray:
    """Host twin of pack_mask: (..., W) bool/0-1 -> (..., n32) int32."""
    packed = np.packbits(np.asarray(bits).astype(bool), axis=-1)
    pad = (-packed.shape[-1]) % 4
    if pad:
        packed = np.pad(packed, [(0, 0)] * (packed.ndim - 1) + [(0, pad)])
    return np.ascontiguousarray(packed).view(np.int32)


def unpack_bits_device(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of pack_bits_host on a tensor of any device: (..., n32)
    int32 -> (..., width) uint8 with values 0/1."""
    as_bytes = packed.to(torch.int32).contiguous().view(torch.uint8)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (as_bytes[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]

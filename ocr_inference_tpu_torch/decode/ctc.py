"""Greedy CTC best path as plain torch ops, counterpart of
ocr_inference_tpu/decode/ctc.py:26-110.

The collapse runs where the logits are, so only one packed (B, T+2) int32
array — ids, length, confidence bits — leaves the card per batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def greedy_decode(logits: torch.Tensor, blank: int = 0):
    """(B, T, V) logits -> ids (B, T) int32 left-packed and padded with -1,
    lengths (B,) int32, conf (B,) float32 = mean max log-prob over the
    non-blank frames. Blanks are dropped and repeats collapsed."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    best = torch.argmax(logp, dim=-1).to(torch.int32)  # first max, as jnp
    best_logp = logp.amax(dim=-1)
    prev = torch.nn.functional.pad(best[:, :-1], (1, 0), value=-1)
    keep = (best != blank) & (best != prev)
    t = best.shape[1]
    pos = torch.arange(t, dtype=torch.int64, device=best.device)[None, :]
    order = torch.argsort(torch.where(keep, pos, pos + t), dim=-1)
    packed = torch.gather(best, 1, order)
    lengths = keep.sum(dim=-1).to(torch.int32)
    ids = torch.where(pos < lengths[:, None], packed, -1).to(torch.int32)
    nonblank = best != blank
    denom = nonblank.sum(dim=-1).clamp(min=1)
    conf = torch.where(nonblank, best_logp, 0.0).sum(dim=-1) / denom
    return ids, lengths, conf.to(torch.float32)


def greedy_decode_packed(logits: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """greedy_decode packed into one (B, T+2) int32 tensor, row =
    [ids..., length, float32 bits of conf]; unpack with
    unpack_greedy_host."""
    ids, lengths, conf = greedy_decode(logits, blank)
    conf_bits = conf.contiguous().view(torch.int32)
    return torch.cat([ids, lengths[:, None], conf_bits[:, None]], dim=1)


def unpack_greedy_host(packed: np.ndarray):
    """Host inverse of greedy_decode_packed -> (ids, lengths, conf)."""
    arr = np.ascontiguousarray(packed, dtype=np.int32)
    return arr[:, :-2], arr[:, -2], arr[:, -1:].view(np.float32)[:, 0]


def ids_to_tokens(ids: np.ndarray, length: int, charset: Sequence[str],
                  add_blank: bool) -> list[str]:
    """Packed vocab ids -> charset units (blank at index 0 when add_blank;
    reference: BDRC/inference.py:90-112)."""
    out = []
    for i in range(length):
        v = int(ids[i])
        if add_blank:
            if v <= 0:
                continue
            out.append(charset[v - 1])
        elif v >= 0:
            out.append(charset[v])
    return out

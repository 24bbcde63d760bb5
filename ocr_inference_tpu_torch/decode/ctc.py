"""CTC decoding: greedy best path as plain torch ops, and the host prefix
beam search (counterpart of ocr_inference_tpu/decode/ctc.py).

The greedy collapse runs where the logits are, so only one packed (B, T+2)
int32 array — ids, length, confidence bits — leaves the card per batch.
The beam search is the JAX package's host search copied operation for
operation (numpy float64), so that both packages give the same beams,
scores and ties on the same logits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

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


# ---------------------------------------------------------------------------
# Host prefix beam search (eval mode / LM fusion)
# ---------------------------------------------------------------------------

@dataclass
class Beam:
    """One decoded hypothesis (pyctcdecode OutputBeam-compatible fields,
    reference usage: BDRC/inference.py:693-721)."""

    text: str
    tokens: tuple[int, ...]
    logit_score: float  # total log P(prefix | logits) (+ LM contribution)
    lm_score: Optional[float] = None


LMScoreFn = Callable[[tuple[int, ...], int], float]
# (prefix_token_ids, next_token_id) -> log10 prob contribution


def _logsumexp2(a: float, b: float) -> float:
    if a == -np.inf:
        return b
    if b == -np.inf:
        return a
    m = max(a, b)
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def beam_search(
    logits: np.ndarray,
    charset: Sequence[str],
    add_blank: bool = True,
    beam_width: int = 64,
    lm_score_fn: Optional[LMScoreFn] = None,
    lm_alpha: float = 0.5,
    lm_beta: float = 0.0,
    prune_logp: float = -10.0,
    top_k: int = 10,
) -> list[Beam]:
    """CTC prefix beam search over one line's (T, V) logits.

    Standard p_blank / p_non_blank prefix merge; optional character-level
    n-gram LM fusion (shallow fusion: alpha * log10 p_lm * ln10 + beta per
    emitted token). The default beam width matches the reference's 64
    (reference: BDRC/inference.py:83).
    """
    logits = np.asarray(logits, dtype=np.float64)
    # log-softmax (pyctcdecode likewise normalizes raw logits)
    logp = logits - logits.max(axis=-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=-1, keepdims=True))
    t_steps, vocab = logp.shape
    blank = 0 if add_blank else -1
    ln10 = np.log(10.0)

    # prefix -> [p_blank, p_non_blank, lm_total]
    beams: dict[tuple[int, ...], list[float]] = {(): [0.0, -np.inf, 0.0]}

    for t in range(t_steps):
        frame = logp[t]
        cand = np.where(frame >= max(frame.max() + prune_logp, -np.inf))[0]
        next_beams: dict[tuple[int, ...], list[float]] = {}

        def get(prefix, lm_total):
            entry = next_beams.get(prefix)
            if entry is None:
                entry = [-np.inf, -np.inf, lm_total]
                next_beams[prefix] = entry
            return entry

        for prefix, (pb, pnb, lm_total) in beams.items():
            p_total = _logsumexp2(pb, pnb)
            for v in cand:
                p = frame[v]
                if v == blank:
                    entry = get(prefix, lm_total)
                    entry[0] = _logsumexp2(entry[0], p_total + p)
                    continue
                last = prefix[-1] if prefix else None
                if v == last:
                    # repeat: extends p_nb of same prefix...
                    entry = get(prefix, lm_total)
                    entry[1] = _logsumexp2(entry[1], pnb + p)
                    # ...or starts a new unit after an intervening blank
                    new_prefix = prefix + (int(v),)
                    lm_add = 0.0
                    if lm_score_fn is not None:
                        lm_add = lm_alpha * lm_score_fn(prefix, int(v)) * ln10 + lm_beta
                    entry = get(new_prefix, lm_total + lm_add)
                    entry[1] = _logsumexp2(entry[1], pb + p + lm_add)
                else:
                    new_prefix = prefix + (int(v),)
                    lm_add = 0.0
                    if lm_score_fn is not None:
                        lm_add = lm_alpha * lm_score_fn(prefix, int(v)) * ln10 + lm_beta
                    entry = get(new_prefix, lm_total + lm_add)
                    entry[1] = _logsumexp2(entry[1], p_total + p + lm_add)

        scored = sorted(
            next_beams.items(),
            key=lambda kv: _logsumexp2(kv[1][0], kv[1][1]),
            reverse=True,
        )
        beams = dict(scored[:beam_width])

    results = []
    for prefix, (pb, pnb, lm_total) in beams.items():
        total = _logsumexp2(pb, pnb)
        if add_blank:
            units = [charset[i - 1] for i in prefix if i > 0]
        else:
            units = [charset[i] for i in prefix]
        results.append(
            Beam(
                text="".join(units),
                tokens=prefix,
                logit_score=float(total),
                lm_score=float(lm_total) if lm_score_fn is not None else None,
            )
        )
    results.sort(key=lambda b: b.logit_score, reverse=True)
    return results[:top_k]

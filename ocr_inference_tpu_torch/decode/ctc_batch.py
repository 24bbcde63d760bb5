"""Batched CTC prefix beam search for eval-mode decoding (copy of
ocr_inference_tpu/decode/ctc_batch.py, operation for operation, so that
both packages keep the same beams on the same logits).

The scalar search (decode.ctc.beam_search) is a per-line Python loop over
T x V x beams — fine for one line, a wall for distribution-scale evaluation
(the reference cross-eval loops whole datasets one line at a time,
reference: BDRC/inference.py:400-414, 1013-1040). This module decodes a
whole (B, T, V) logits batch at once: every per-frame step is vectorized
across lines x beams x vocabulary with numpy, and prefix merging — the part
that makes CTC prefix search hard to batch — is done with salted rolling
hashes + one global sort-segment-reduce per frame instead of per-line dicts.

Semantics match decode.ctc.beam_search exactly (same candidate pruning,
same p_blank/p_non_blank transitions, same beam_width truncation); the
equivalence is pinned by tests/test_torch_beams.py. LM-fused search stays
on the scalar path (shallow fusion calls a scorer per candidate), which the
engines use only when a KenLM config is present.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ocr_inference_tpu_torch.decode.ctc import Beam

_H0 = np.uint64(1469598103934665603)      # FNV-1a offset basis
_HMUL = np.uint64(1099511628211)          # FNV-1a prime
_LINE_SALT = np.uint64(0x9E3779B97F4A7C15)

_NEG_INF = -np.inf


def _hash_extend(h: np.ndarray, token: np.ndarray | int) -> np.ndarray:
    """Rolling prefix hash: h' = (h * P) xor (token + 1)."""
    t = np.asarray(token, dtype=np.uint64) + np.uint64(1)
    return (h * _HMUL) ^ t


def beam_search_batch(
    logits: np.ndarray,
    charset: Sequence[str],
    add_blank: bool = True,
    beam_width: int = 64,
    prune_logp: float = -10.0,
    top_k: int = 10,
) -> list[list[Beam]]:
    """Prefix beam search over a (B, T, V) logits batch.

    Returns, per line, the top_k Beams sorted by logit_score — the same
    contract as running decode.ctc.beam_search per line with lm_score_fn
    None (reference beam decode surface: BDRC/inference.py:117-118).
    """
    logits = np.asarray(logits, dtype=np.float64)
    if logits.ndim == 2:
        logits = logits[None]
    b_lines, t_steps, vocab = logits.shape
    # log-softmax (matches the scalar path)
    logp = logits - logits.max(axis=-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(axis=-1, keepdims=True))
    blank = 0 if add_blank else -1

    w = beam_width
    line_idx = np.arange(b_lines)

    # Beam state. Dead beam slots carry score -inf and never win selection.
    # Prefix contents are not materialized during the loop (copying (B, W, T)
    # token arrays per frame is gigabytes of memcpy); instead each frame
    # records (parent slot, appended token) backpointers and sequences are
    # reconstructed once at the end.
    length = np.zeros((b_lines, w), np.int32)
    pb = np.full((b_lines, w), _NEG_INF)
    pnb = np.full((b_lines, w), _NEG_INF)
    pb[:, 0] = 0.0                       # the empty prefix
    last = np.full((b_lines, w), -1, np.int32)
    phash = np.full((b_lines, w), _H0, np.uint64)
    # line salt keeps one global hash space collision-free across lines
    salt = (np.uint64(1) + line_idx.astype(np.uint64)) * _LINE_SALT
    trace_parent: list[np.ndarray] = []
    trace_tok: list[np.ndarray] = []

    with np.errstate(divide="ignore", invalid="ignore"):
        for t in range(t_steps):
            frame = logp[:, t, :]                     # (B, V)
            cand = frame >= frame.max(axis=1, keepdims=True) + prune_logp
            p_total = np.logaddexp(pb, pnb)           # (B, W)

            # -- same-prefix contributions --
            # blank extends p_b of the same prefix
            if blank >= 0:
                p_blank = np.where(cand[:, blank : blank + 1],
                                   frame[:, blank : blank + 1], _NEG_INF)
            else:
                p_blank = np.full((b_lines, 1), _NEG_INF)
            same_pb = p_total + p_blank               # (B, W)
            # repeating the last unit extends p_nb of the same prefix
            last_safe = np.maximum(last, 0)
            p_last = np.take_along_axis(frame, last_safe, axis=1)  # (B, W)
            cand_last = np.take_along_axis(cand, last_safe, axis=1)
            rep_ok = (last >= 0) & cand_last
            same_pnb = np.where(rep_ok, pnb + p_last, _NEG_INF)

            # -- extension contributions --
            # Pruning is a per-line VALUE threshold, so the top-nv frame
            # entries (nv = max surviving candidate count this frame)
            # contain every survivor of every line: expanding only those
            # keeps exact semantics while shrinking the pool from V (78)
            # to typically 2-6 on peaky CTC frames.
            nv = max(int(cand.sum(axis=1).max()), 1)
            nv = min(nv, vocab)
            if nv < vocab:
                cand_tokens = np.argpartition(-frame, nv - 1, axis=1)[:, :nv]
            else:
                cand_tokens = np.broadcast_to(
                    np.arange(vocab, dtype=np.int64), (b_lines, vocab)
                )
            cand_tokens = np.ascontiguousarray(cand_tokens)
            pv = np.take_along_axis(frame, cand_tokens, axis=1)   # (B, nv)
            cv = np.take_along_axis(cand, cand_tokens, axis=1)
            cv = cv & (cand_tokens != blank)
            is_rep = last[:, :, None] == cand_tokens[:, None, :]
            base = np.where(is_rep, pb[:, :, None], p_total[:, :, None])
            ext = np.where(cv[:, None, :], base + pv[:, None, :], _NEG_INF)
            ext_hash = _hash_extend(
                phash[:, :, None],
                np.broadcast_to(
                    cand_tokens[:, None, :], (b_lines, w, nv)
                ),
            )

            # -- pool all entries and merge equal prefixes globally --
            n_same, n_ext = w, w * nv
            pool_hash = np.concatenate(
                [phash.reshape(b_lines, -1), ext_hash.reshape(b_lines, -1)],
                axis=1,
            ) ^ salt[:, None]
            pool_pb = np.concatenate(
                [same_pb, np.full((b_lines, n_ext), _NEG_INF)], axis=1
            )
            pool_pnb = np.concatenate(
                [same_pnb, ext.reshape(b_lines, -1)], axis=1
            )
            n_pool = n_same + n_ext
            flat_hash = pool_hash.ravel()
            flat_pb = pool_pb.ravel()
            flat_pnb = pool_pnb.ravel()
            flat_line = np.repeat(line_idx, n_pool)
            # parent beam slot and appended token of each entry
            parent = np.concatenate(
                [
                    np.arange(w, dtype=np.int32),
                    np.repeat(np.arange(w, dtype=np.int32), nv),
                ]
            )
            flat_parent = np.tile(parent, b_lines)
            ext_tok = np.broadcast_to(
                cand_tokens[:, None, :], (b_lines, w, nv)
            ).reshape(b_lines, -1)
            flat_tok = np.concatenate(
                [np.full((b_lines, w), -1, np.int64), ext_tok], axis=1
            ).ravel()

            # drop dead entries early (both scores -inf)
            alive = (flat_pb > _NEG_INF) | (flat_pnb > _NEG_INF)
            flat_hash, flat_pb, flat_pnb = (
                flat_hash[alive], flat_pb[alive], flat_pnb[alive]
            )
            flat_line, flat_parent, flat_tok = (
                flat_line[alive], flat_parent[alive], flat_tok[alive]
            )

            # group entries with identical (line-salted) prefix hash
            order = np.argsort(flat_hash, kind="stable")
            sh = flat_hash[order]
            starts = np.flatnonzero(
                np.concatenate([[True], sh[1:] != sh[:-1]])
            )
            # segmented log-sum-exp of pb and pnb per group
            def seg_lse(vals):
                v = vals[order]
                seg_max = np.maximum.reduceat(v, starts)
                safe_max = np.where(np.isfinite(seg_max), seg_max, 0.0)
                shifted = np.exp(
                    v - np.repeat(safe_max, np.diff(
                        np.concatenate([starts, [len(v)]])
                    ))
                )
                shifted = np.where(np.isfinite(v), shifted, 0.0)
                seg_sum = np.add.reduceat(shifted, starts)
                out = np.where(
                    seg_sum > 0.0, safe_max + np.log(seg_sum), _NEG_INF
                )
                return out

            g_pb = seg_lse(flat_pb)
            g_pnb = seg_lse(flat_pnb)
            g_score = np.logaddexp(g_pb, g_pnb)
            rep = order[starts]                      # one representative entry
            g_line = flat_line[rep]
            g_parent = flat_parent[rep]
            g_tok = flat_tok[rep]

            # top-W per line by score (stable on ties like sorted())
            sel_order = np.lexsort((-g_score, g_line))
            sl = g_line[sel_order]
            first = np.concatenate([[True], sl[1:] != sl[:-1]])
            group_start = np.flatnonzero(first)
            rank = np.arange(len(sl)) - np.repeat(
                group_start, np.diff(np.concatenate([group_start, [len(sl)]]))
            )
            keep = sel_order[rank < w]
            kline, kparent, ktok = g_line[keep], g_parent[keep], g_tok[keep]
            kpb, kpnb = g_pb[keep], g_pnb[keep]
            # slot within each line
            kl_order = np.argsort(kline, kind="stable")
            kline, kparent, ktok = (
                kline[kl_order], kparent[kl_order], ktok[kl_order]
            )
            kpb, kpnb = kpb[kl_order], kpnb[kl_order]
            ls = np.flatnonzero(
                np.concatenate([[True], kline[1:] != kline[:-1]])
            )
            slot = np.arange(len(kline)) - np.repeat(
                ls, np.diff(np.concatenate([ls, [len(kline)]]))
            )

            # materialize next state + backpointer frame
            new_length = np.zeros_like(length)
            new_pb = np.full_like(pb, _NEG_INF)
            new_pnb = np.full_like(pnb, _NEG_INF)
            new_last = np.full_like(last, -1)
            new_hash = np.full((b_lines, w), _H0, np.uint64)
            frame_parent = np.full((b_lines, w), -1, np.int32)
            frame_tok = np.full((b_lines, w), -1, np.int64)

            plen = length[kline, kparent]
            is_ext = ktok >= 0
            new_length[kline, slot] = plen + is_ext.astype(np.int32)
            new_pb[kline, slot] = kpb
            new_pnb[kline, slot] = kpnb
            new_last[kline, slot] = np.where(
                is_ext, ktok, last[kline, kparent]
            )
            new_hash[kline, slot] = np.where(
                is_ext,
                _hash_extend(phash[kline, kparent], np.maximum(ktok, 0)),
                phash[kline, kparent],
            )
            frame_parent[kline, slot] = kparent
            frame_tok[kline, slot] = ktok
            trace_parent.append(frame_parent)
            trace_tok.append(frame_tok)

            length, pb, pnb = new_length, new_pb, new_pnb
            last, phash = new_last, new_hash

    def _reconstruct(b: int, slot_i: int) -> tuple[int, ...]:
        out: list[int] = []
        s_cur = slot_i
        for t in range(len(trace_parent) - 1, -1, -1):
            tok = int(trace_tok[t][b, s_cur])
            if tok >= 0:
                out.append(tok)
            s_cur = int(trace_parent[t][b, s_cur])
            if s_cur < 0:
                break
        out.reverse()
        return tuple(out)

    # harvest top_k per line
    results: list[list[Beam]] = []
    score = np.logaddexp(pb, pnb)
    for b in range(b_lines):
        order = np.argsort(-score[b], kind="stable")
        beams = []
        for i in order[:top_k]:
            if not np.isfinite(score[b, i]):
                continue
            toks = _reconstruct(b, int(i))
            if add_blank:
                units = [charset[v - 1] for v in toks if v > 0]
            else:
                units = [charset[v] for v in toks]
            beams.append(
                Beam(
                    text="".join(units),
                    tokens=toks,
                    logit_score=float(score[b, i]),
                    lm_score=None,
                )
            )
        results.append(beams)
    return results

"""Character n-gram ARPA builder (Witten-Bell interpolated), a copy of
ocr_inference_tpu/decode/ngram_builder.py that writes the same bytes.

The reference consumes pre-built KenLM character LMs over Wylie text
(reference: BDRC/utils.py:132-159 downloads .binary/.arpa pairs;
BDRC/inference.py:97-104 feeds them to pyctcdecode). Without kenlm's
tools the package BUILDS a compatible ARPA from a text corpus itself —
the eval suite's LM is built this way — writable into the framework's own
.binary/trie formats via decode.kenlm_binary / decode.kenlm_trie.

Smoothing is interpolated Witten-Bell, chosen because it emits exactly
normalized ARPA models with no tuning constants:

    P(w | h) = (c(hw) + T(h) * P(w | h')) / (c(h) + T(h))
    bo(h)    = T(h) / (c(h) + T(h))

where T(h) = number of distinct continuations of context h and h' drops the
oldest token. Unigrams interpolate with the uniform distribution over the
vocabulary (including <unk>), so every probability is strictly positive and
sum_w P(w|h) == 1 for every context (pinned by tests/test_ngram_builder.py
for the JAX package's builder).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from math import log10
from pathlib import Path
from typing import Iterable, Sequence

BOS, EOS, UNK = "<s>", "</s>", "<unk>"


def _count_ngrams(
    sentences: Iterable[Sequence[str]], order: int
) -> list[Counter]:
    """counts[n-1][gram tuple] for n = 1..order; BOS-padded, EOS-closed."""
    counts = [Counter() for _ in range(order)]
    for toks in sentences:
        seq = [BOS] * (order - 1) + list(toks) + [EOS]
        for i in range(order - 1, len(seq)):
            for n in range(1, order + 1):
                if n == 1 and seq[i] == BOS:
                    continue
                gram = tuple(seq[i - n + 1 : i + 1])
                counts[n - 1][gram] += 1
        # BOS contexts for orders < full (e.g. the bigram (<s>, w) needs the
        # unigram-context count of <s> as a context, handled via counts of
        # grams starting at BOS positions above)
    return counts


def build_char_arpa(
    corpus: Iterable[str],
    out_path: str | Path,
    order: int = 3,
    tokens: bool = False,
) -> Path:
    """Count character (or, with ``tokens=True``, pre-split token) n-grams
    over ``corpus`` lines and write an interpolated Witten-Bell ARPA file.

    Returns the written path. The model contains every seen n-gram (no
    pruning — OCR charset LMs are tiny) plus <s>, </s>, <unk>.
    """
    # ARPA tokens cannot contain whitespace; in char mode spaces map to the
    # framework's tsheg symbol "§" (the label-encoder convention,
    # reference: BDRC/label_encoder.py:51). Token mode expects lines
    # pre-joined from charset units (e.g. Wylie stacks like "tsh").
    sentences = [
        ["§" if ch == " " else ch for ch in line]
        if not tokens
        else line.split()
        for line in corpus
        if line
    ]
    counts = _count_ngrams(sentences, order)

    # context statistics per order: total count and distinct continuations
    ctx_total: list[dict] = [defaultdict(int) for _ in range(order)]
    ctx_types: list[dict] = [defaultdict(int) for _ in range(order)]
    for n in range(1, order + 1):
        for gram, c in counts[n - 1].items():
            ctx = gram[:-1]
            ctx_total[n - 1][ctx] += c
            ctx_types[n - 1][ctx] += 1

    # scoring vocabulary = seen unigrams (EOS included, BOS excluded by
    # counting) plus <unk>; the uniform base must run over exactly this set
    # for sum_w P(w|h) == 1
    total1 = ctx_total[0][()]
    types1 = ctx_types[0][()]
    uniform = 1.0 / (types1 + 1)

    # probs[n-1][gram] = interpolated P(w | context), built bottom-up
    probs: list[dict] = [dict() for _ in range(order)]

    denom1 = total1 + types1
    for gram, c in counts[0].items():
        probs[0][gram] = (c + types1 * uniform) / denom1
    probs[0][(UNK,)] = types1 * uniform / denom1

    def backoff(ctx: tuple) -> float:
        """bo weight of a context (stored on that gram's ARPA line)."""
        t = ctx_types[len(ctx)][ctx]
        if t == 0:
            return 1.0
        return t / (ctx_total[len(ctx)][ctx] + t)

    def effective_p(ctx: tuple, w: str) -> float:
        """P(w | ctx) exactly as an ARPA backoff scorer computes it."""
        factor = 1.0
        while True:
            g = ctx + (w,)
            n = len(g)
            if n <= order and g in probs[n - 1]:
                return factor * probs[n - 1][g]
            if n == 1:
                return factor * probs[0][(UNK,)]
            factor *= backoff(ctx)
            ctx = ctx[1:]

    for n in range(2, order + 1):
        for gram, c in counts[n - 1].items():
            ctx = gram[:-1]
            t = ctx_types[n - 1][ctx]
            denom = ctx_total[n - 1][ctx] + t
            probs[n - 1][gram] = (
                c + t * effective_p(ctx[1:], gram[-1])
            ) / denom

    # <s> is a context, never a prediction: conventional -99 placeholder
    # line carries its backoff weight
    probs[0][(BOS,)] = 1e-99

    out_path = Path(out_path)
    lines = ["", "\\data\\"]
    n_entries = [len(probs[i]) for i in range(order)]
    for n in range(1, order + 1):
        lines.append(f"ngram {n}={n_entries[n - 1]}")
    for n in range(1, order + 1):
        lines.append("")
        lines.append(f"\\{n}-grams:")
        for gram in sorted(probs[n - 1]):
            p = probs[n - 1][gram]
            lp = log10(max(p, 1e-99))
            text = " ".join(gram)
            if n < order:
                # backoff weight of this gram used as an order-(n+1) context
                bo = backoff(gram)
                lines.append(f"{lp:.6f}\t{text}\t{log10(bo):.6f}")
            else:
                lines.append(f"{lp:.6f}\t{text}")
    lines.append("")
    lines.append("\\end\\")
    lines.append("")
    out_path.write_text("\n".join(lines), encoding="utf-8")
    return out_path

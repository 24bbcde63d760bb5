"""Character error rate: corpus Levenshtein distance over characters
divided by the total reference length (copy of
ocr_inference_tpu/eval/cer.py, HF evaluate's "cer"), and its bootstrap
confidence interval."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def levenshtein(a: str, b: str) -> int:
    """Edit distance (substitution/insert/delete, all cost 1)."""
    if len(b) > len(a):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        curr = [i]
        for j, cb in enumerate(b, start=1):
            curr.append(min(prev[j] + 1, curr[j - 1] + 1,
                            prev[j - 1] + (ca != cb)))
        prev = curr
    return prev[-1]


class CERScorer:
    """HF-evaluate-compatible surface: compute(predictions, references)."""

    def compute(self, predictions: Sequence[str],
                references: Sequence[str]) -> float:
        if len(predictions) != len(references):
            raise ValueError("predictions and references length mismatch")
        dist = sum(levenshtein(p, r) for p, r in zip(predictions, references))
        total = sum(len(r) for r in references)
        if total == 0:
            return 0.0 if dist == 0 else float(dist)
        return dist / total


def cer(predictions: Sequence[str], references: Sequence[str]) -> float:
    return CERScorer().compute(predictions, references)


def cer_bootstrap_ci(
    predictions: Sequence[str],
    references: Sequence[str],
    n_boot: int = 1000,
    seed: int = 0,
    alpha: float = 0.05,
) -> tuple[float, float]:
    """Percentile bootstrap CI for the corpus CER (eval/cer.py:65-90):
    resample (prediction, reference) pairs with replacement, recompute the
    corpus ratio, return the (alpha/2, 1 - alpha/2) quantiles."""
    if len(predictions) != len(references):
        raise ValueError("predictions and references length mismatch")
    dists = np.array(
        [levenshtein(p, r) for p, r in zip(predictions, references)],
        dtype=np.float64,
    )
    lens = np.array([len(r) for r in references], dtype=np.float64)
    n = len(dists)
    if n == 0 or lens.sum() == 0:
        return (0.0, 0.0)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_boot, n))
    boot = dists[idx].sum(axis=1) / np.maximum(lens[idx].sum(axis=1), 1.0)
    lo, hi = np.quantile(boot, [alpha / 2.0, 1.0 - alpha / 2.0])
    return (float(lo), float(hi))

"""Character error rate: corpus Levenshtein distance over characters
divided by the total reference length (copy of
ocr_inference_tpu/eval/cer.py, HF evaluate's "cer")."""

from __future__ import annotations

from typing import Sequence


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


def cer(predictions: Sequence[str], references: Sequence[str]) -> float:
    if len(predictions) != len(references):
        raise ValueError("predictions and references length mismatch")
    dist = sum(levenshtein(p, r) for p, r in zip(predictions, references))
    total = sum(len(r) for r in references)
    if total == 0:
        return 0.0 if dist == 0 else float(dist)
    return dist / total

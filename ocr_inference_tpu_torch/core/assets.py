"""LM asset helpers (copy of ocr_inference_tpu/core/assets.py:160-186).
The download functions of the JAX module are not part of the port: the
machines it runs on have no network."""

from __future__ import annotations

from pathlib import Path

from ocr_inference_tpu_torch.core.data import KenLMConfig


def parse_arpa_unigrams(arpa_path: str | Path) -> list[str] | None:
    """Extract the \\1-grams: token column from an ARPA LM file
    (reference: BDRC/utils.py:395-427)."""
    unigrams: list[str] = []
    in_1grams = False
    with open(arpa_path, "r", encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if line == r"\1-grams:":
                in_1grams = True
                continue
            if in_1grams and line.startswith("\\"):
                break
            if in_1grams:
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    unigrams.append(parts[1])
    return unigrams or None


def get_kenlm_config(model_path: str | Path,
                     arpa_file: str | Path) -> KenLMConfig:
    """Bundle LM paths + unigrams (reference: BDRC/utils.py:429-436)."""
    return KenLMConfig(model_path, arpa_file, parse_arpa_unigrams(arpa_file))

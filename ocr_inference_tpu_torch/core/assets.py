"""Model asset helpers: the JSON config readers and the LM helpers (copy of
ocr_inference_tpu/core/assets.py:75-192). They read the per-model JSON
config format of the BDRC model repos (reference: BDRC/utils.py:162-436),
"yes"/"no" string booleans included. The download functions of the JAX
module are not part of the port: the machines it runs on have no network."""

from __future__ import annotations

import json
import os
from pathlib import Path

from ocr_inference_tpu_torch.core.config import CHARSETENCODER
from ocr_inference_tpu_torch.core.data import (
    KenLMConfig,
    LayoutDetectionConfig,
    LineDetectionConfig,
    OCRModel,
    OCRModelConfig,
    generate_guid,
)


def _yes(value) -> bool:
    # The shipped configs encode booleans as "yes"/"no" strings
    # (reference: BDRC/utils.py:371-376); accept real booleans too.
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() == "yes"


def read_ocr_model_config(config_file: str) -> OCRModelConfig:
    """Parse a recognizer model_config.json (reference: BDRC/utils.py:349-393)."""
    model_dir = os.path.dirname(config_file)
    with open(config_file, encoding="utf-8") as f:
        cfg = json.load(f)

    return OCRModelConfig(
        model_file=os.path.join(model_dir, cfg["onnx-model"]),
        architecture=cfg["architecture"],
        input_width=int(cfg["input_width"]),
        input_height=int(cfg["input_height"]),
        input_layer=cfg["input_layer"],
        output_layer=cfg["output_layer"],
        squeeze_channel=_yes(cfg["squeeze_channel_dim"]),
        swap_hw=_yes(cfg["swap_hw"]),
        encoder=CHARSETENCODER[cfg["encoder"]],
        charset=get_charset(cfg["charset"]),
        add_blank=_yes(cfg["add_blank"]),
        version=str(cfg["version"]),
    )


def read_line_model_config(config_file: str) -> LineDetectionConfig:
    """Parse a line segmentation config (reference: BDRC/utils.py:162-180)."""
    model_dir = os.path.dirname(config_file)
    with open(config_file, encoding="utf-8") as f:
        cfg = json.load(f)
    return LineDetectionConfig(
        checkpoint=os.path.join(model_dir, cfg["checkpoint"]),
        onnx_file=os.path.join(model_dir, cfg["onnx-model"]),
        architecture=cfg["architecture"],
        patch_size=int(cfg["patch_size"]),
        classes=cfg["classes"],
    )


def read_layout_model_config(config_file: str) -> LayoutDetectionConfig:
    """Parse a layout segmentation config (reference: BDRC/utils.py:183-207).

    The reference defaults architecture to "deeplabv3" when absent but then
    re-reads the key unconditionally (utils.py:191-196), crashing on
    configs without it; here the default takes effect."""
    model_dir = os.path.dirname(config_file)
    with open(config_file, encoding="utf-8") as f:
        cfg = json.load(f)
    return LayoutDetectionConfig(
        checkpoint=os.path.join(model_dir, cfg["checkpoint"]),
        onnx_file=os.path.join(model_dir, cfg["onnx-model"]),
        architecture=cfg.get("architecture", "deeplabv3"),
        patch_size=int(cfg["patch_size"]),
        classes=cfg["classes"],
    )


def get_charset(charset: str | list[str]) -> list[str]:
    """Charset string or list -> list of unit strings
    (reference: BDRC/utils.py:210-217)."""
    return list(charset)


def import_local_model(model_path: str) -> OCRModel | None:
    """Load an OCRModel from a directory holding model_config.json
    (reference: BDRC/utils.py:322-346)."""
    if not os.path.isdir(model_path):
        return None
    config_file = os.path.join(model_path, "model_config.json")
    if not os.path.isfile(config_file):
        return None
    return OCRModel(
        guid=generate_guid(1),
        name=Path(model_path).name,
        path=model_path,
        config=read_ocr_model_config(config_file),
    )


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


def get_filename(file_path: str) -> str:
    """Basename without extension (reference: BDRC/utils.py:232-244)."""
    segments = os.path.basename(file_path).split(".")[:-1]
    return ".".join(segments) if segments else os.path.basename(file_path)

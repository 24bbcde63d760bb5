"""Drop-in compatibility shims for the third-party runtimes the port
replaces; counterpart of ocr_inference_tpu/compat.

Code written against the reference stack's dependencies — ``onnxruntime``
sessions (reference: BDRC/inference.py:128,294), ``pyctcdecode`` decoders
(inference.py:97-106), ``pyewts`` converters (inference.py:452) and
``botok`` tokenizers (label_encoder.py:7) — can run unmodified on this
framework: each shim implements the consumed API surface on top of the
port's own equivalents (onnx/ executor, decode/, text/).

Usage::

    from ocr_inference_tpu_torch import compat
    compat.install()          # registers all absent modules
    import onnxruntime as ort # -> the torch-executor-backed shim

``install`` never shadows a genuinely installed package unless
``force=True``; it registers shims only for names that fail to import.

tests/test_torch_onnx_compat.py holds each shim against the JAX
package's on the same inputs.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys


def _absent(name: str) -> bool:
    if name in sys.modules:
        return False
    try:
        return importlib.util.find_spec(name) is None
    except (ImportError, ValueError):
        return True


def install_onnxruntime(force: bool = False) -> bool:
    """Register the executor-backed ``onnxruntime`` module."""
    if not force and not _absent("onnxruntime"):
        return False
    from ocr_inference_tpu_torch.compat import ort as _ort

    sys.modules["onnxruntime"] = _ort
    return True


def install_pyctcdecode(force: bool = False) -> bool:
    """Register ``pyctcdecode`` (+ ``pyctcdecode.decoder``) backed by
    decode/."""
    if not force and not _absent("pyctcdecode"):
        return False
    from ocr_inference_tpu_torch.compat import ctcdecode as _ctc

    sys.modules["pyctcdecode"] = _ctc
    sys.modules["pyctcdecode.decoder"] = _ctc.decoder
    return True


def install_pyewts(force: bool = False) -> bool:
    """Register ``pyewts`` backed by text/ewts."""
    if not force and not _absent("pyewts"):
        return False
    import types

    from ocr_inference_tpu_torch.text import Converter

    mod = types.ModuleType("pyewts")
    mod.pyewts = Converter  # pyewts.pyewts() -> converter object
    sys.modules["pyewts"] = mod
    return True


def install_botok(force: bool = False) -> bool:
    """Register ``botok``'s consumed surface (normalize_unicode,
    tokenize_in_stacks) backed by text/ewts."""
    if not force and not _absent("botok"):
        return False
    import types

    from ocr_inference_tpu_torch.text import (
        normalize_unicode,
        tokenize_in_stacks,
    )

    mod = types.ModuleType("botok")
    mod.normalize_unicode = normalize_unicode
    mod.tokenize_in_stacks = tokenize_in_stacks
    sys.modules["botok"] = mod
    return True


def install(force: bool = False) -> dict[str, bool]:
    """Install every shim; returns {module_name: installed_now}."""
    return {
        "onnxruntime": install_onnxruntime(force),
        "pyctcdecode": install_pyctcdecode(force),
        "pyewts": install_pyewts(force),
        "botok": install_botok(force),
    }

"""The port's compat shims (ocr_inference_tpu_torch/compat) against the
JAX package's: the onnxruntime session over each package's executor, the
pyctcdecode decoder over each package's CTCDecoder, pyewts and botok over
each package's text/. Each test restores ``sys.modules``.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np
import pytest
import torch

MODS = ("onnxruntime", "pyctcdecode", "pyctcdecode.decoder", "pyewts",
        "botok")


@pytest.fixture
def clean_modules():
    saved = {m: sys.modules.get(m) for m in MODS}
    for m in MODS:
        sys.modules.pop(m, None)
    yield
    for m, v in saved.items():
        if v is None:
            sys.modules.pop(m, None)
        else:
            sys.modules[m] = v


def _installed(package: str) -> dict:
    """Install ``package``'s shims (forced), return the modules, unhook."""
    compat = importlib.import_module(f"{package}.compat")
    assert all(compat.install(force=True).values())
    mods = {m: sys.modules[m] for m in MODS}
    for m in MODS:
        sys.modules.pop(m, None)
    return mods


def test_install_registers_the_ports_shims(clean_modules):
    from ocr_inference_tpu_torch import compat

    assert compat.install(force=True) == dict.fromkeys(
        ("onnxruntime", "pyctcdecode", "pyewts", "botok"), True)
    import botok  # noqa: F401
    import onnxruntime
    import pyctcdecode
    import pyewts  # noqa: F401

    assert onnxruntime.__name__ == "ocr_inference_tpu_torch.compat.ort"
    assert "CPUExecutionProvider" in onnxruntime.get_available_providers()
    assert pyctcdecode.decoder.OutputBeam is not None


def test_install_never_shadows_a_present_module(clean_modules):
    """Without force, a module that imports (here: one already in
    sys.modules) is left alone."""
    from ocr_inference_tpu_torch import compat

    marker = object()
    sys.modules["pyewts"] = marker
    assert compat.install_pyewts() is False
    assert sys.modules["pyewts"] is marker
    assert compat.install_pyewts(force=True) is True
    assert sys.modules["pyewts"] is not marker


def test_ort_session_matches_jax(clean_modules, tmp_path):
    """InferenceSession + OrtValue on an exporter file, called as the
    reference's Detection._predict calls it (inference.py:152-157): the
    port's outputs equal JAX's."""
    from ocr_inference_tpu.models.torch_twins import TUNet
    from ocr_inference_tpu_torch.onnx.export_shim import torch_export

    torch.manual_seed(0)
    tm = TUNet(width=8).eval()
    path = str(tmp_path / "unet.onnx")
    torch_export(tm, torch.randn(1, 3, 64, 64), path,
                 input_names=["input"], output_names=["output"])
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    outs = {}
    for package in ("ocr_inference_tpu", "ocr_inference_tpu_torch"):
        ort = _installed(package)["onnxruntime"]
        session = ort.InferenceSession(path, providers=[
            "CPUExecutionProvider"])
        assert [i.name for i in session.get_inputs()] == ["input"]
        assert [o.name for o in session.get_outputs()] == ["output"]
        value = ort.OrtValue.ortvalue_from_numpy(x)
        got = session.run_with_ort_values(["output"], {"input": value})
        outs[package] = got[0].numpy()
        np.testing.assert_array_equal(
            session.run(None, {"input": x})[0], outs[package])
    assert outs["ocr_inference_tpu_torch"].shape == (2, 1, 64, 64)
    assert np.max(np.abs(outs["ocr_inference_tpu_torch"]
                         - outs["ocr_inference_tpu"])) < 1e-4
    with torch.no_grad():
        ref = tm(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(outs["ocr_inference_tpu_torch"] - ref)) < 1e-4


def test_ort_session_from_bytes_and_missing_input(clean_modules, tmp_path):
    from ocr_inference_tpu_torch.compat import ort
    from ocr_inference_tpu_torch.onnx.wire import (
        encode_model,
        encode_node,
        encode_value_info,
    )

    raw = encode_model([encode_node("Relu", ["x"], ["y"])], [],
                       [encode_value_info("x", 1, [2])],
                       [encode_value_info("y", 1, [2])])
    session = ort.InferenceSession(raw, providers=["CPUExecutionProvider"])
    assert session.get_providers() == ["CPUExecutionProvider"]
    np.testing.assert_array_equal(
        session.run(["y"], {"x": np.array([-1.0, 2.0], np.float32)})[0],
        [0.0, 2.0])
    with pytest.raises(ValueError, match="missing input 'x'"):
        session.run(None, {})


def _frames(ids, v, rng):
    t = rng.normal(size=(len(ids), v)).astype(np.float32)
    for i, k in enumerate(ids):
        t[i, k] += 6.0
    return t


def test_ctcdecode_decode_and_beams_match_jax(clean_modules):
    labels = ["<blk>", "a", "b", "c", "d"]
    rng = np.random.default_rng(3)
    logits = [_frames([1, 1, 0, 2, 2, 3], 5, rng),
              _frames([4, 0, 4, 0, 1, 2, 2, 0], 5, rng),
              rng.normal(size=(12, 5)).astype(np.float32)]
    results = {}
    for package in ("ocr_inference_tpu", "ocr_inference_tpu_torch"):
        ctc = _installed(package)["pyctcdecode"]
        dec = ctc.build_ctcdecoder(labels)
        out = []
        for t in logits:
            beams = dec.decode_beams(t, beam_width=8)
            assert all(isinstance(b, ctc.decoder.OutputBeam) for b in beams)
            out.append((dec.decode(t), [(b.text, b.logit_score, b.lm_score)
                                        for b in beams]))
        results[package] = out
        with pytest.raises(ValueError, match="index 0"):
            ctc.build_ctcdecoder(["a", "<blk>", "b"])
    got, want = results["ocr_inference_tpu_torch"], results[
        "ocr_inference_tpu"]
    assert got[0][0] == want[0][0] == "abc"
    for (gt, gb), (wt, wb) in zip(got, want):
        assert gt == wt
        assert [b[0] for b in gb] == [b[0] for b in wb]
        np.testing.assert_allclose([b[1:] for b in gb], [b[1:] for b in wb],
                                   rtol=1e-5, atol=1e-4)


def test_ctcdecode_with_lm_matches_jax(clean_modules):
    """kenlm_model_path: shallow fusion with the repository's ARPA LM."""
    from pathlib import Path

    arpa = Path(__file__).resolve().parents[1] / "artifacts" / "full77f" \
        / "lm.arpa"
    import json

    meta = json.loads((arpa.parent / "recognizer.msgpack.json").read_text())
    labels = ["<blk>"] + list(meta["charset"])
    rng = np.random.default_rng(5)
    t = _frames([3, 0, 7, 7, 0, 12, 1, 0, 3], len(labels), rng)
    texts = {}
    for package in ("ocr_inference_tpu", "ocr_inference_tpu_torch"):
        ctc = _installed(package)["pyctcdecode"]
        dec = ctc.build_ctcdecoder(labels, kenlm_model_path=str(arpa),
                                   alpha=0.5, beta=0.1)
        texts[package] = [b.text for b in dec.decode_beams(t, beam_width=8)]
    assert texts["ocr_inference_tpu_torch"] == texts["ocr_inference_tpu"]


def test_pyewts_and_botok_match_jax(clean_modules):
    samples = ["ka", "bkra shis bde legs/", "rgyal po'i", "sangs rgyas"]
    out = {}
    for package in ("ocr_inference_tpu", "ocr_inference_tpu_torch"):
        mods = _installed(package)
        conv = mods["pyewts"].pyewts()
        uni = [conv.toUnicode(s) for s in samples]
        out[package] = (uni, [conv.toWylie(u) for u in uni],
                        [mods["botok"].tokenize_in_stacks(u) for u in uni],
                        [mods["botok"].normalize_unicode(u) for u in uni])
    assert out["ocr_inference_tpu_torch"] == out["ocr_inference_tpu"]

"""The port's builders on ``.onnx`` model files (pipeline/builder.py), on
the CPU in float32, against the JAX package and the port's own msgpack
path.

- The refpipe weights (tests/data/refpipe, a UNet of width 8 and a small
  Easter2) exported through the port's ``torch_export``: the ONNX
  pipeline reads the refpipe pages with the texts and boxes of the port's
  msgpack pipeline and of the JAX msgpack pipeline.
- full77f's UNet and Easter2 exported the same way: a fixture page's texts
  and boxes against the JAX float32 record (tests/data/torch_port/
  texts.json).
- JAX ``build_pipeline`` against the port's on the same ``.onnx`` files.
  JAX jit-compiles the graph, and its lowerings turn the shape chains a
  TorchScript export of a UNet or an Easter2 carries (Shape -> ... ->
  Transpose -> Pad) into traced values that ``jnp.pad`` cannot take, so
  the JAX builder cannot run those exports (ROADMAP §3); these graphs are
  a conv detector (a line's ink density, no shape chain) and a conv
  recognizer.
- The order of resolution, the builders' dtype, and the CLIs on a model
  directory that holds only ``.onnx`` files.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.eval.synthetic import (
    WYLIE_CHARSET,
    GlyphSet,
    render_page,
)
from ocr_inference_tpu.pipeline.builder import build_pipeline as jax_build
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.models.params import (
    save_params,
    seeded_flax_params,
)
from ocr_inference_tpu_torch.onnx import OnnxModule
from ocr_inference_tpu_torch.onnx.export_shim import torch_export
from ocr_inference_tpu_torch.pipeline import build_pipeline
from ocr_inference_tpu_torch.pipeline.builder import (
    build_detection_engine,
    build_recognition_engine,
)
from tests import make_refpipe_fixture as fx
from tests.make_torch_port_fixture import full77f_configs

REPO = Path(__file__).resolve().parents[1]
REFPIPE = REPO / "tests" / "data" / "refpipe"
FIXTURE = REPO / "tests" / "data" / "torch_port"
REC_AXES = {"input": {0: "batch", 2: "width"}}
DET_AXES = {"input": {0: "batch"}}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _configs(mod, rec_file, det_file, charset, width, height=80,
             **rec_kw):
    ocr = mod.OCRModelConfig(
        model_file=str(rec_file), architecture="Easter2", input_width=width,
        input_height=height, input_layer="input", output_layer="output",
        squeeze_channel=True, swap_hw=False,
        encoder=mod.CharsetEncoder.WYLIE, charset=list(charset),
        add_blank=True, version="onnx", **rec_kw)
    line = mod.LineDetectionConfig(
        checkpoint="", onnx_file=str(det_file), architecture="unet",
        patch_size=512, classes=["line"])
    return ocr, line


def _export_pipeline(ocr_cfg, line_cfg, out: Path):
    """The port's msgpack modules of these configs exported to
    out/recognizer.onnx and out/lines.onnx (no msgpack beside them)."""
    out.mkdir(parents=True, exist_ok=True)
    rec = build_recognition_engine(ocr_cfg, dtype=torch.float32,
                                   device="cpu").model
    det = build_detection_engine(line_cfg, dtype=torch.float32,
                                 device="cpu").model
    torch_export(rec, torch.rand(2, ocr_cfg.input_height, 256),
                 str(out / "recognizer.onnx"), input_names=["input"],
                 output_names=["output"], dynamic_axes=REC_AXES)
    torch_export(det, torch.rand(2, 3, 512, 512), str(out / "lines.onnx"),
                 input_names=["input"], output_names=["output"],
                 dynamic_axes=DET_AXES)
    return rec, out / "recognizer.onnx", out / "lines.onnx"


def _refpipe_pages():
    glyphs = GlyphSet(height=fx.GLYPH_H, seed=7)
    rng = np.random.RandomState(20_260)
    return [render_page(rng, glyphs, WYLIE_CHARSET, n_lines=(3, 5),
                        page_w=512, align="left", n_syllables=fx.N_SYLLABLES,
                        syllable_len=fx.SYLLABLE_LEN).image
            for _ in range(2)]


def _read(pipe, img, mod=data):
    """(texts, boxes, angle) of run_ocr; ``mod`` is the package's data
    module (the JAX pipeline takes its own Encoding)."""
    status, payload = pipe.run_ocr(img, target_encoding=mod.Encoding.WYLIE)
    assert status.name == "SUCCESS", payload
    _, lines, ocr_lines, angle = payload
    return ([ln.text for ln in ocr_lines],
            [list(ln.bbox.as_tuple()) for ln in lines], angle)


@pytest.fixture(scope="module")
def refpipe(tmp_path_factory):
    out = tmp_path_factory.mktemp("refpipe_onnx")
    msgpack_cfgs = _configs(data, REFPIPE / "recognizer.onnx",
                            REFPIPE / "lines.onnx", WYLIE_CHARSET, fx.CANVAS,
                            fx.INPUT_H)
    module, rec, det = _export_pipeline(*msgpack_cfgs, out)
    onnx_cfgs = _configs(data, rec, det, WYLIE_CHARSET, fx.CANVAS,
                         fx.INPUT_H)
    return msgpack_cfgs, onnx_cfgs, module, out


def test_refpipe_onnx_pipeline_reads_as_msgpack_and_jax(refpipe):
    msgpack_cfgs, onnx_cfgs, module, _ = refpipe
    pipe = build_pipeline(*onnx_cfgs, dtype=torch.float32, device="cpu")
    assert isinstance(pipe.ocr_inference.model, OnnxModule)
    assert isinstance(pipe.line_inference.model, OnnxModule)
    assert pipe.line_inference.open_width_frac == 0.0
    ours = build_pipeline(*msgpack_cfgs, dtype=torch.float32, device="cpu")
    theirs = jax_build(*_configs(jdata, REFPIPE / "recognizer.onnx",
                                 REFPIPE / "lines.onnx", WYLIE_CHARSET,
                                 fx.CANVAS, fx.INPUT_H), dtype=jnp.float32)
    for img in _refpipe_pages():
        got = _read(pipe, img)
        assert got[0] and any(got[0])
        assert got == _read(ours, img)
        assert got == _read(theirs, img, jdata)
    # the recognizer's logits against the module it was exported from
    x = torch.rand(8, fx.INPUT_H, fx.CANVAS) * 2 - 1
    with torch.no_grad():
        want = module(x)
    got = pipe.ocr_inference.model(x)
    assert float((got - want).abs().max()) < 1e-4


def test_full77f_onnx_page_matches_the_jax_record(tmp_path):
    """full77f's UNet (width 32, stem 2) and Easter2 as ``.onnx`` files:
    the fixture page's texts and boxes equal the JAX float32 record of an
    ONNX detector's settings (onnx.json: no opening). clean_b is the page
    where that differs from the msgpack path's texts.json: one thin
    tile-edge line more."""
    cfgs = full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                           data.CharsetEncoder.WYLIE)
    _, rec, det = _export_pipeline(*cfgs, tmp_path)
    meta = json.loads((REPO / "artifacts/full77f/recognizer.msgpack.json")
                      .read_text())
    pipe = build_pipeline(*_configs(data, rec, det, meta["charset"], 3000),
                          dtype=torch.float32, device="cpu")
    def record(name):
        return {p["name"]: p for p in json.loads(
            (FIXTURE / name).read_text(encoding="utf-8"))["pages"]}

    name, img, _ = fixture_pages(FIXTURE / "pages.npz")[1]
    texts, boxes, _ = _read(pipe, img)
    assert texts == record("onnx.json")[name]["jax_f32_texts"]
    assert boxes == record("onnx.json")[name]["jax_f32_boxes"]
    msgpack = record("texts.json")[name]
    assert len(boxes) == len(msgpack["jax_f32_boxes"]) + 1


def _handcrafted(out: Path, charset) -> tuple[Path, Path]:
    """A detector whose logit is a line's ink density (one 9 x 41 box
    filter over the binarized tile) and a seeded conv recognizer, both
    free of shape chains, so that JAX's jit can run them."""
    det = torch.nn.Conv2d(3, 1, (9, 41), padding=(4, 20))
    gain = 50.0
    with torch.no_grad():
        det.weight.fill_(-gain / det.weight[0].numel())
        det.bias.fill_(0.85 * gain)  # ink density above 0.15 is a line
    torch_export(det.eval(), torch.rand(8, 3, 512, 512),
                 str(out / "det.onnx"), input_names=["input"],
                 output_names=["output"], dynamic_axes=DET_AXES)
    torch.manual_seed(0)
    rec = torch.nn.Conv1d(80, len(charset) + 1, 4, stride=4)
    with torch.no_grad():
        rec.weight.mul_(20.0)
    torch_export(rec.eval(), torch.rand(2, 80, 256), str(out / "rec.onnx"),
                 input_names=["input"], output_names=["output"],
                 dynamic_axes=REC_AXES)
    return out / "rec.onnx", out / "det.onnx"


def test_jax_and_port_builders_agree_on_onnx_files(tmp_path):
    charset = list(WYLIE_CHARSET)
    rec, det = _handcrafted(tmp_path, charset)
    pipe = build_pipeline(*_configs(data, rec, det, charset, 1024,
                                    ), dtype=torch.float32, device="cpu")
    theirs = jax_build(*_configs(jdata, rec, det, charset, 1024),
                       dtype=jnp.float32)
    _, img, _ = fixture_pages(FIXTURE / "pages.npz")[0]
    got = _read(pipe, img)
    assert len(got[0]) >= 3 and any(got[0])
    assert got == _read(theirs, img, jdata)


def _small_easter2_msgpack(path: Path, vocab: int):
    from ocr_inference_tpu_torch.models.params import flax_shapes
    from ocr_inference_tpu_torch.models.recognition import Easter2

    meta = {"width_mult": 0.125, "stem_features": 16}
    tree = seeded_flax_params(flax_shapes(Easter2(vocab, 80, **meta)), 1)
    save_params(tree, path, meta=meta)


def test_order_of_resolution_and_dtype(refpipe, tmp_path, monkeypatch):
    """msgpack beside the file first, then the .onnx, then allow_random,
    else FileNotFoundError; the builders' dtype does not reach the graph,
    OCR_ONNX_BF16=1 does."""
    from ocr_inference_tpu_torch.models.recognition import Easter2
    from ocr_inference_tpu_torch.models.segmentation import UNet

    _, (ocr_cfg, line_cfg), _, _ = refpipe
    vocab = len(ocr_cfg.charset) + 1
    rec = build_recognition_engine(ocr_cfg, dtype=torch.bfloat16,
                                   device="cpu")
    det = build_detection_engine(line_cfg, dtype=torch.bfloat16,
                                 device="cpu")
    for engine in (rec, det):
        assert isinstance(engine.model, OnnxModule)
        assert engine.model.fn.dtype is None
        assert all(t.dtype != torch.bfloat16
                   for t in engine.model.fn.weights.values())
    monkeypatch.setenv("OCR_ONNX_BF16", "1")
    assert build_recognition_engine(ocr_cfg, device="cpu").model.fn.dtype \
        == torch.bfloat16
    monkeypatch.delenv("OCR_ONNX_BF16")

    # a msgpack beside the .onnx wins
    d = tmp_path / "both"
    d.mkdir()
    (d / "recognizer.onnx").write_bytes(Path(ocr_cfg.model_file)
                                        .read_bytes())
    _small_easter2_msgpack(d / "recognizer.msgpack", vocab)
    cfg = _configs(data, d / "recognizer.onnx", line_cfg.onnx_file,
                   ocr_cfg.charset, fx.CANVAS)[0]
    assert isinstance(build_recognition_engine(cfg, device="cpu").model,
                      Easter2)
    # neither file: allow_random builds seeded weights, else it raises
    cfg = _configs(data, tmp_path / "none.onnx", tmp_path / "none_l.onnx",
                   ocr_cfg.charset, fx.CANVAS)
    assert isinstance(build_recognition_engine(
        cfg[0], allow_random=True, device="cpu").model, Easter2)
    assert isinstance(build_detection_engine(
        cfg[1], allow_random=True, device="cpu").model, UNet)
    with pytest.raises(FileNotFoundError):
        build_recognition_engine(cfg[0], device="cpu")
    with pytest.raises(FileNotFoundError):
        build_detection_engine(cfg[1], device="cpu")


def test_clis_run_an_onnx_model_directory(refpipe, tmp_path, capsys):
    """bocr --model DIR (onnx-model without msgpack) reads each page as
    run_ocr does; bocr-lines --checkpoint X.onnx writes a row per page."""
    from ocr_inference_tpu_torch.cli import cli, infer_lines_cli
    from ocr_inference_tpu_torch.io.artifacts import write_png
    from ocr_inference_tpu_torch.io.parquet import read_table

    _, (ocr_cfg, line_cfg), _, out = refpipe
    model = tmp_path / "model"
    model.mkdir()
    (model / "model_config.json").write_text(json.dumps({
        "onnx-model": str(ocr_cfg.model_file), "architecture": "Easter2",
        "input_width": fx.CANVAS, "input_height": fx.INPUT_H,
        "input_layer": "input", "output_layer": "output",
        "squeeze_channel_dim": "yes", "swap_hw": "no", "encoder": "wylie",
        "charset": list(WYLIE_CHARSET), "add_blank": "yes",
        "version": "onnx"}))
    lines = tmp_path / "lines"
    lines.mkdir()
    (lines / "config.json").write_text(json.dumps({
        "checkpoint": "", "onnx-model": str(line_cfg.onnx_file),
        "architecture": "unet", "patch_size": 512, "classes": ["line"]}))
    pages = tmp_path / "pages"
    pages.mkdir()
    imgs = _refpipe_pages()
    for i, img in enumerate(imgs):
        write_png(pages / f"page{i}.png", img[..., ::-1])
    assert cli.main(["--model", str(model), "--folder", str(pages),
                     "--output", str(tmp_path / "out"), "--line-model",
                     str(lines), "--device", "cpu"]) == 0
    pipe = build_pipeline(ocr_cfg, line_cfg, dtype=torch.float32,
                          device="cpu")
    for i, img in enumerate(imgs):
        _, payload = pipe.run_ocr(img, target_encoding=data.Encoding.UNICODE)
        want = "\n".join(ln.text for ln in payload[2])
        got = (tmp_path / "out" / f"page{i}.txt").read_text(encoding="utf-8")
        assert got.strip() == want.strip() and want.strip()
    assert infer_lines_cli.main(["-i", str(pages), "-o",
                                 str(tmp_path / "pq"), "-c",
                                 str(line_cfg.onnx_file), "--device",
                                 "cpu"]) in (0, None)
    rows = [read_table(p) for p in sorted((tmp_path / "pq").glob("*.parquet"))]
    assert len(rows) == 2


def test_serve_and_eval_run_an_onnx_model_directory(refpipe, tmp_path,
                                                    monkeypatch, capsys):
    """bocr-serve answers pages from a model directory that holds only
    .onnx files with run_ocr's texts; bocr-eval's evaluator scores a line
    dataset through the .onnx recognizer as through its msgpack."""
    import io

    from ocr_inference_tpu_torch.cli import evaluate_cli, serve_cli
    from ocr_inference_tpu_torch.eval.evaluator import OCREvaluator
    from ocr_inference_tpu_torch.eval.synthetic import (
        line_dataset,
        load_glyphs,
        write_line_dataset,
    )
    from ocr_inference_tpu_torch.io.artifacts import write_png

    msgpack_cfgs, (ocr_cfg, line_cfg), _, _ = refpipe
    dirs = {}
    for name, cfg in (("onnx", ocr_cfg), ("msgpack", msgpack_cfgs[0])):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        (dirs[name] / "model_config.json").write_text(json.dumps({
            "onnx-model": str(cfg.model_file), "architecture": "Easter2",
            "input_width": fx.CANVAS, "input_height": fx.INPUT_H,
            "input_layer": "input", "output_layer": "output",
            "squeeze_channel_dim": "yes", "swap_hw": "no",
            "encoder": "wylie", "charset": list(WYLIE_CHARSET),
            "add_blank": "yes", "version": name}))
    lines = tmp_path / "lines.json"
    lines.write_text(json.dumps({
        "checkpoint": "", "onnx-model": str(line_cfg.onnx_file),
        "architecture": "unet", "patch_size": 512, "classes": ["line"]}))
    img = _refpipe_pages()[0]
    write_png(tmp_path / "page.png", img[..., ::-1])
    monkeypatch.setattr("sys.stdin", io.StringIO(
        json.dumps({"image": str(tmp_path / "page.png")}) + "\n\n"))
    assert serve_cli.main(["--model", str(dirs["onnx"]), "--line-model",
                           str(lines), "--encoding", "wylie", "--device",
                           "cpu"]) == 0
    (served,) = [json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines()]
    pipe = build_pipeline(ocr_cfg, line_cfg, dtype=torch.float32,
                          device="cpu")
    assert served["status"] == "success"
    assert [ln["text"] for ln in served["lines"]] == _read(pipe, img)[0]

    glyphs, charset = load_glyphs(FIXTURE / "pages.npz")
    write_line_dataset(tmp_path / "data", line_dataset(glyphs, charset))
    dists = evaluate_cli.collect_distributions(str(tmp_path / "data"))
    scores = {}
    for name, d in dirs.items():
        evaluator = OCREvaluator(str(d / "model_config.json"),
                                 device="cpu", dtype=torch.float32)
        scores[name] = {dist: evaluator.evaluate_distribution(
            dist, images, labels).cer_scores
            for dist, (images, labels) in dists.items()}
    assert scores["onnx"] == scores["msgpack"]
    assert sum(len(v) for v in scores["onnx"].values()) == 48

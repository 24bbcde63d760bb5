"""The port's serving entry point (``python -m
ocr_inference_tpu_torch.cli.serve_cli``), on the CPU: the cases of
tests/test_serve_cli.py (dynamic batching over an os.pipe, overload
shedding, the JSONL protocol); the fixture pages served in float32 give the
JAX package's recorded float32 texts and boxes, as PNG and as the JPEG and
TIFF files of tests/data/torch_port/images; a JPEG 2000 TIFF request
fails by name; a device fault ends the session."""

import io
import json
import os

import numpy as np
import pytest
import torch

from ocr_inference_tpu_torch.cli import serve_cli
from ocr_inference_tpu_torch.cli.serve_cli import _LineReader, main, serve_loop
from ocr_inference_tpu_torch.device import DeviceFault
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.io.artifacts import write_png
from tests.image_writers import jpeg2000_tiff
from tests.make_torch_port_fixture import OUT, WEIGHTS


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class _StubRecord:
    def __init__(self, name):
        self.name = name


class _StubRunner:
    def __init__(self):
        self.bursts = []

    def run(self, images, on_page_done=None, **kw):
        images = list(images)
        self.bursts.append([name for name, _ in images])
        recs = [_StubRecord(name) for name, _ in images]
        for r in recs:
            on_page_done(r)
        return recs


def _pipe_of(*requests: str) -> int:
    r_fd, w_fd = os.pipe()
    for req in requests:
        os.write(w_fd, req.encode() + b"\n")
    os.close(w_fd)
    return r_fd


def test_serve_loop_dynamic_batching_over_pipe():
    """Queued requests drain into one burst, each page emits exactly once,
    EOF ends the session."""
    runner, emitted = _StubRunner(), []
    r_fd = _pipe_of(*(json.dumps({"image": p})
                      for p in ("a.png", "b.png", "c.png", "d.png")))
    serve_loop(
        runner, _LineReader(fd=r_fd), lambda p: (lambda: None),
        emitted.append, lambda obj: (_ for _ in ()).throw(AssertionError(obj)),
        encoding=None,
    )
    os.close(r_fd)
    assert sum(len(b) for b in runner.bursts) == 4
    assert len(runner.bursts) <= 2
    assert [r.name for r in emitted] == ["a.png", "b.png", "c.png", "d.png"]


def test_serve_loop_overload_shedding():
    """max_queue bounds a burst: the overflow is shed with a 429 line, the
    admitted pages are served."""
    runner, emitted, errors = _StubRunner(), [], []
    r_fd = _pipe_of(*(json.dumps({"image": p})
                      for p in ("a.png", "b.png", "c.png", "d.png", "e.png")))
    serve_loop(runner, _LineReader(fd=r_fd), lambda p: (lambda: None),
               emitted.append, errors.append, encoding=None, max_queue=3)
    os.close(r_fd)
    assert [r.name for r in emitted] == ["a.png", "b.png", "c.png"]
    assert [e["image"] for e in errors] == ["d.png", "e.png"]
    assert all(e["status"] == "shed" and e["code"] == 429 for e in errors)
    assert all("max_queue=3" in e["error"] for e in errors)
    assert all(len(b) <= 3 for b in runner.bursts)


def test_serve_loop_blank_line_ends_the_session():
    runner, emitted = _StubRunner(), []
    r_fd = _pipe_of(json.dumps({"image": "a.png"}), "",
                    json.dumps({"image": "never.png"}))
    serve_loop(runner, _LineReader(fd=r_fd), lambda p: (lambda: None),
               emitted.append, lambda obj: None, encoding=None)
    os.close(r_fd)
    assert [r.name for r in emitted] == ["a.png"]


def _model_dir(tmp_path, charset="kg'abcdefh", input_width=512,
               onnx="ocr.onnx"):
    d = tmp_path / "model"
    d.mkdir()
    (d / "model_config.json").write_text(json.dumps({
        "onnx-model": onnx, "architecture": "Easter2", "version": "1",
        "input_width": input_width, "input_height": 80,
        "input_layer": "input", "output_layer": "output", "encoder": "wylie",
        "squeeze_channel_dim": "yes", "swap_hw": "no", "charset": charset,
        "add_blank": "yes",
    }))
    return d


def _serve(monkeypatch, capsys, requests: list[str], *args) -> tuple:
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(requests) + "\n"))
    rc = main([*args, "--device", "cpu", "--dtype", "float32"])
    out = [json.loads(line)
           for line in capsys.readouterr().out.strip().splitlines()]
    return rc, out


def test_serve_jsonl_protocol(tmp_path, monkeypatch, capsys):
    """Per-request responses with error isolation: a page, a bad JSON line,
    a request without an image, a batch with a missing file, a JPEG cut
    inside its headers (unreadable, as cv2 finds it) and a JPEG 2000 TIFF
    named .jpg that fails naming its variant; a blank line ends
    the session."""
    model_dir = _model_dir(tmp_path)
    page = tmp_path / "page.png"
    write_png(page, np.full((600, 900, 3), 230, np.uint8))
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00")
    jpeg = tmp_path / "scan.jpg"
    jpeg.write_bytes(jpeg2000_tiff())
    rc, out = _serve(monkeypatch, capsys, [
        json.dumps({"image": str(page)}),
        "not json",
        json.dumps({"wrong": "key"}),
        json.dumps({"images": [str(page), str(tmp_path / "missing.png")]}),
        json.dumps({"image": str(cut)}),
        json.dumps({"image": str(jpeg)}),
        "",
        json.dumps({"image": str(page)}),
    ], "--model", str(model_dir), "--allow-random-weights",
        "--window-pages", "1")
    assert rc == 0
    # 1 page + 1 bad-json error + 1 bad-request error + 2 batch pages +
    # the two JPEGs; nothing after the blank line
    assert len(out) == 7
    assert out[0]["image"] == str(page)
    assert out[0]["status"] in ("success", "failed")
    assert "bad request" in out[1]["error"]
    assert "no 'image'" in out[2]["error"]
    statuses = {r["image"]: r for r in out[3:]}
    assert statuses[str(tmp_path / "missing.png")]["status"] == "failed"
    assert str(page) in statuses
    assert statuses[str(cut)]["status"] == "failed"
    refused = statuses[str(jpeg)]
    assert refused["status"] == "failed"
    assert "JPEG 2000 in TIFF (compression 34712) is not supported" in \
        refused["error"]


def test_served_fixture_pages_give_the_jax_float32_record(tmp_path,
                                                         monkeypatch, capsys):
    """The three fixture pages as PNG through the service with the full77f
    weights in float32: the JAX float32 texts and line boxes of
    tests/data/torch_port/texts.json, one response per page; and a JPEG
    (EXIF orientation 6) and a Group 4 TIFF of them: the JAX float32 texts
    and boxes of tests/data/torch_port/images.json."""
    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    model_dir = _model_dir(tmp_path, charset=meta["charset"],
                           input_width=3000,
                           onnx=str(WEIGHTS / "recognizer.onnx"))
    line_cfg = tmp_path / "lines.json"
    line_cfg.write_text(json.dumps({
        "checkpoint": "", "onnx-model": str(WEIGHTS / "lines.onnx"),
        "architecture": "unet", "patch_size": 512, "classes": ["line"]}))
    record = json.loads((OUT / "texts.json").read_text(encoding="utf-8"))
    want = {p["name"]: p for p in record["pages"]}
    paths = {}
    for name, img, _ in fixture_pages(OUT / "pages.npz"):
        paths[name] = str(tmp_path / f"{name}.png")
        write_png(paths[name], img[..., ::-1])
    images = json.loads((OUT / "images.json").read_text(encoding="utf-8"))
    for name in ("clean_b_exif6.jpg", "skew_2deg_g4.tif"):
        paths[name] = str(OUT / "images" / "pages" / name)
        want[name] = images["bocr"][name]
    rc, out = _serve(monkeypatch, capsys,
                     [json.dumps({"images": list(paths.values())})],
                     "--model", str(model_dir), "--line-model", str(line_cfg),
                     "--encoding", "wylie", "--window-pages", "2")
    assert rc == 0
    assert [r["image"] for r in out] == list(paths.values())
    for name, path in paths.items():
        rec = next(r for r in out if r["image"] == path)
        assert rec["status"] == "success"
        assert [ln["text"] for ln in rec["lines"]] == want[name][
            "jax_f32_texts"]
        assert [ln["bbox"] for ln in rec["lines"]] == want[name][
            "jax_f32_boxes"]


def test_device_fault_ends_the_session(tmp_path, monkeypatch, capsys):
    """A CUDA error is not one page's failure: the last line names it and
    the process exits 1, the rest of the stream unserved."""

    class FaultyRunner(_StubRunner):
        def run(self, images, on_page_done=None, **kw):
            raise DeviceFault("ocr_binarize launch failed: CUDA error 700")

    monkeypatch.setattr(serve_cli, "build_pipeline", lambda *a, **k: None)
    monkeypatch.setattr(serve_cli, "VolumeRunner",
                        lambda pipe, window_pages: FaultyRunner())
    rc, out = _serve(monkeypatch, capsys, [
        json.dumps({"image": "a.png"}), json.dumps({"image": "b.png"})],
        "--model", str(_model_dir(tmp_path)))
    assert rc == 1
    assert out[-1]["status"] == "failed" and out[-1]["fatal"] is True
    assert "CUDA error 700" in out[-1]["error"]


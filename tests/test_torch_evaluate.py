"""The port's eval CLI (``python -m ocr_inference_tpu_torch.cli.evaluate_cli``,
``bocr-eval``), its OCREvaluator and the label encoders, against the JAX
package on the CPU: the encoders on tests/test_text.py's cases;
``collect_distributions``; on a PNG line dataset of two distributions
(eval/synthetic.py ``line_dataset``) with the full77f weights in float32,
the per-line CERs and the score files equal to the JAX ``bocr-eval``'s
(made float32 here: its OCREvaluator passes no dtype), and the CER of
lines read as JPEG and TIFF equal to the JAX evaluator's; the whole-line
binarize byte for byte against ``binarize_host``."""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocr_inference_tpu.eval.evaluator as jax_evaluator
from ocr_inference_tpu import text as jax_text
from ocr_inference_tpu.cli import evaluate_cli as jax_cli
from ocr_inference_tpu.ops_host import binarize_host
from ocr_inference_tpu_torch import text
from ocr_inference_tpu_torch.cli import evaluate_cli
from ocr_inference_tpu_torch.eval.evaluator import (
    OCREvaluator,
    binarize_lines_async,
)
from ocr_inference_tpu_torch.eval.synthetic import (
    line_dataset,
    load_glyphs,
    write_line_dataset,
)
from ocr_inference_tpu_torch.io.artifacts import write_png
from tests.image_writers import jpeg2000_tiff
from tests.make_torch_port_fixture import OUT, WEIGHTS

REPO = Path(__file__).resolve().parents[1]
# the Unicode labels of tests/test_text.py and the label-cleanup cases
LABELS = [
    "ཀ", "དགའ", "བསྒྲུབས", "དབྱངས", "གཡག", "གྱག", "བའི", "གྲྭ", "༡༩༨༤",
    "བཀྲ་ཤིས་བདེ་ལེགས།", "ཀ༌ཁ", "ཀ(ཁ)ག", "ཀ ཁ\tག‍", "ཀ ཁ*ག",
    "࿓ཀ", "ཨོཾ་མ་ཎི་པདྨེ་ཧཱུྃ།", "ཀ",
]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("label", LABELS)
def test_label_encoders_match_jax(tmp_path, label):
    path = tmp_path / "label.txt"
    path.write_text(label + "\nsecond line\n", encoding="utf-8")
    wylie = list("abcdefghijklmnopqrstuvwxyz'/§ ")
    stacks = ["བ", "ཀྲ", "ཤི", "ས", "་", "།", "ཀ"]
    for ours, theirs in (
        (text.WylieEncoder(wylie), jax_text.WylieEncoder(wylie)),
        (text.StackEncoder(stacks), jax_text.StackEncoder(stacks)),
    ):
        got = ours.read_label(str(path))
        assert got == theirs.read_label(str(path))
        assert ours.encode(got) == theirs.encode(got)
        assert (ours.ctc_vocab, ours.num_classes, ours.concat_charset) == (
            theirs.ctc_vocab, theirs.num_classes, theirs.concat_charset)
    for full in (False, True):
        assert text.preprocess_unicode(label, full) == \
            jax_text.preprocess_unicode(label, full)
    wy = text.to_wylie(label)
    assert text.postprocess_wylie_label(wy) == \
        jax_text.postprocess_wylie_label(wy)


def test_encoder_ctc_decode_matches_jax():
    logits = np.random.default_rng(0).standard_normal((40, 6)).astype(
        np.float32)
    ours, theirs = text.WylieEncoder("abcde"), jax_text.WylieEncoder("abcde")
    assert ours.ctc_decode(logits) == theirs.ctc_decode(logits)
    assert ours.decode([1, 3, 5]) == theirs.decode([1, 3, 5]) == "ace"


def _touch_dataset(root: Path):
    for dist, names in (("uchan_b", ["l0.png", "l1.jpg", "l2.tif",
                                     "lonely.png", "x.bmp"]),
                        ("uchan_a", ["a.PNG", "b.jpeg"]),
                        ("empty", ["n.png"])):
        folder = root / dist
        folder.mkdir(parents=True)
        for name in names:
            (folder / name).write_bytes(b"")
            if dist != "empty" and not name.startswith("lonely"):
                (folder / (name.rsplit(".", 1)[0] + ".txt")).write_text("ཀ")
    (root / "README.txt").write_text("not a distribution")


def test_collect_distributions_matches_jax(tmp_path):
    _touch_dataset(tmp_path)
    got = evaluate_cli.collect_distributions(str(tmp_path))
    assert got == jax_cli.collect_distributions(str(tmp_path))
    assert set(got) == {"uchan_a", "uchan_b"}
    assert [Path(p).name for p in got["uchan_b"][0]] == [
        "l0.png", "l1.jpg", "l2.tif"]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The line dataset as PNG, a full77f model directory, and the JAX
    bocr-eval's score files for it, the JAX recognizer in float32."""
    root = tmp_path_factory.mktemp("eval")
    glyphs, charset = load_glyphs(OUT / "pages.npz")
    write_line_dataset(root / "data", line_dataset(glyphs, charset))
    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    (root / "model").mkdir()
    (root / "model" / "model_config.json").write_text(json.dumps({
        "onnx-model": str(WEIGHTS / "recognizer.onnx"),
        "architecture": "Easter2", "input_width": 3000, "input_height": 80,
        "input_layer": "input", "output_layer": "output",
        "squeeze_channel_dim": "yes", "swap_hw": "no", "encoder": "wylie",
        "charset": meta["charset"], "add_blank": "yes",
        "version": "full77f"}))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_evaluator, "build_recognition_engine", functools.partial(
        jax_evaluator.build_recognition_engine, dtype=jnp.float32))
    try:
        assert jax_cli.main(["--model", str(root / "model"), "--dataset",
                             str(root / "data"), "--output",
                             str(root / "jax")]) == 0
    finally:
        mp.undo()
    return root


def test_evaluate_distribution_matches_jax_per_line(job):
    want = json.loads((job / "jax" / "Easter2.json").read_text())
    evaluator = OCREvaluator(str(job / "model" / "model_config.json"),
                             device="cpu", dtype=torch.float32)
    dists = evaluate_cli.collect_distributions(str(job / "data"))
    assert set(dists) == set(want) == {"clean", "degrade_03"}
    for dist, (images, labels) in dists.items():
        result = evaluator.evaluate_distribution(dist, images, labels)
        assert result.distribution == dist
        assert result.image_paths == images
        assert result.cer_scores == want[dist]["per_image"]
        assert len(result.cer_scores) == 24
    # the model reads these lines, if not perfectly: the equality above
    # holds on texts, not on empty strings
    assert want["clean"]["mean_cer"] < 0.5


def test_evaluate_one_line_matches_jax(job, monkeypatch):
    image = job / "data" / "clean" / "line01.png"
    label = image.with_suffix(".txt")
    ours = OCREvaluator(str(job / "model" / "model_config.json"),
                        device="cpu", dtype=torch.float32)
    monkeypatch.setattr(jax_evaluator, "build_recognition_engine",
                        functools.partial(
                            jax_evaluator.build_recognition_engine,
                            dtype=jnp.float32))
    theirs = jax_evaluator.OCREvaluator(
        str(job / "model" / "model_config.json"))
    assert ours.evaluate(str(image), str(label)) == theirs.evaluate(
        str(image), str(label))
    assert ours.get_architecture() == "Easter2"
    # the same lines as JPEG and TIFF files read as the JAX evaluator
    # reads them
    import cv2
    from PIL import Image

    for i, (ext, kw) in enumerate(((".jpg", {"quality": 90}),
                                   (".jpeg", {"quality": 75,
                                              "progressive": True}),
                                   (".tif", {"compression": "tiff_lzw"}),
                                   (".tiff", {"compression": "group4"}))):
        src = job / "data" / "clean" / f"line{i + 2:02d}.png"
        rgb = cv2.imread(str(src))[..., ::-1]
        path = job / "formats" / f"line{i}{ext}"
        path.parent.mkdir(exist_ok=True)
        im = Image.fromarray(np.ascontiguousarray(rgb))
        if kw.get("compression") == "group4":
            im = im.convert("L").point(lambda v: 255 if v > 128 else 0) \
                .convert("1")
        im.save(path, **kw)
        lbl = src.with_suffix(".txt")
        assert ours.evaluate(str(path), str(lbl)) == theirs.evaluate(
            str(path), str(lbl)), ext


def test_an_unreadable_line_raises_file_not_found_where_jax_raises_cv2_error(
        job, tmp_path, monkeypatch):
    """A line image that cannot be read (missing, or cut inside its
    headers): the port's evaluate raises FileNotFoundError naming it, the
    JAX evaluator cv2.error from cvtColor(None). The port has no cv2, so it
    cannot raise cv2's type (ROADMAP §3, deliberate differences)."""
    import cv2

    label = job / "data" / "clean" / "line01.txt"
    cut = tmp_path / "cut.png"
    cut.write_bytes((job / "data" / "clean" / "line01.png").read_bytes()[:20])
    ours = OCREvaluator(str(job / "model" / "model_config.json"),
                        device="cpu", dtype=torch.float32)
    monkeypatch.setattr(jax_evaluator, "build_recognition_engine",
                        functools.partial(
                            jax_evaluator.build_recognition_engine,
                            dtype=jnp.float32))
    theirs = jax_evaluator.OCREvaluator(
        str(job / "model" / "model_config.json"))
    for path in (tmp_path / "missing.png", cut):
        with pytest.raises(FileNotFoundError, match=path.name):
            ours.evaluate(str(path), str(label))
        with pytest.raises(cv2.error):
            theirs.evaluate(str(path), str(label))


def test_eval_cli_score_files_match_jax(job, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "ocr_inference_tpu_torch.cli.evaluate_cli",
         "--model", str(job / "model"), "--dataset", str(job / "data"),
         "--output", str(tmp_path / "port"), "--device", "cpu", "--dtype",
         "float32"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    for name in ("Easter2.txt", "Easter2.json"):
        assert (tmp_path / "port" / name).read_bytes() == (
            job / "jax" / name).read_bytes()
    summary = json.loads(proc.stdout[proc.stdout.index("{"):])
    want = json.loads((job / "jax" / "Easter2.json").read_text())
    assert summary == {"Easter2": {d: r["mean_cer"] for d, r in
                                   want.items()}}


def test_eval_cli_refuses_non_png_lines_by_name(tmp_path):
    """A line image of a variant the port does not decode (here a JPEG 2000
    TIFF named .jpg) is refused by name before any model is loaded:
    the model directory here has no config at all."""
    folder = tmp_path / "data" / "dist"
    folder.mkdir(parents=True)
    write_png(folder / "ok.png", np.full((40, 60, 3), 230, np.uint8))
    (folder / "scan.jpg").write_bytes(jpeg2000_tiff(40, 60))
    for stem in ("ok", "scan"):
        (folder / f"{stem}.txt").write_text("ka\n")
    with pytest.raises(SystemExit) as exc:
        evaluate_cli.main(["--model", str(tmp_path / "no_model"),
                           "--dataset", str(tmp_path / "data"),
                           "--output", str(tmp_path / "out"),
                           "--device", "cpu"])
    assert "scan.jpg (JPEG 2000 in TIFF" in str(exc.value)
    assert not (tmp_path / "out").exists()


def test_whole_line_binarize_equals_binarize_host(job):
    """The evaluator's binarize (the port's gray conversion and the line
    kernel's plain version on the CPU) against cv2's, on the dataset's
    lines (120-180 rows) and on random images of other heights."""
    from ocr_inference_tpu_torch.io.images import read_image

    images = [read_image(p) for p in sorted((job / "data").glob("*/*.png"))]
    rng = np.random.default_rng(3)
    images += [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
               for h, w in ((23, 37), (81, 300), (161, 77), (300, 1024))]
    got = binarize_lines_async(images, torch.device("cpu"))
    for img, pending in zip(images, got):
        want = binarize_host(img)
        assert (want == want[..., :1]).all()
        np.testing.assert_array_equal(pending.get(), want[..., 0])

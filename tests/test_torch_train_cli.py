"""The port's training CLIs (bocr-train, bocr-train-seg, bocr-selftrain)
on the CPU against the JAX package.

The JAX bocr-train and bocr-train-seg build an 8-way mesh under this
suite's 8 CPU devices and cannot split their small batches over it, so
they are held here through their step loop driven as the CLI drives it
with ``mesh=None``: the same datasets (``load_dataset`` and
``load_tiles`` byte-equal), the same ``np.random.default_rng(0)`` batch
indices and the same initial weights (the port's seeded ones, which
bocr-train reads as ``weights.msgpack`` and which the JAX loop is given
for bocr-train-seg). Each logged loss, printed to four decimals, within
5e-4 + 1e-4 relative of the JAX step's (float32)."""

import json
import re

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu_torch.models import params as P

CHARSET = "kg' abcdefhijlmnoprstuwy"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _losses(out: str) -> list[float]:
    return [float(m) for m in re.findall(r"loss (-?[0-9.]+)", out)]


def _close(got: list[float], want: list[float]):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert abs(g - w) <= 5e-4 + 1e-4 * abs(w), (got, want)


@pytest.fixture()
def line_job(tmp_path):
    """A model directory (Easter2, the JAX CLI test's config) with seeded
    weights.msgpack, and four line images with labels."""
    model = tmp_path / "model"
    model.mkdir()
    (model / "model_config.json").write_text(json.dumps({
        "onnx-model": "ocr.onnx", "architecture": "Easter2", "version": "1",
        "input_width": 256, "input_height": 80, "input_layer": "input",
        "output_layer": "output", "encoder": "wylie",
        "squeeze_channel_dim": "yes", "swap_hw": "no", "charset": CHARSET,
        "add_blank": "yes"}))
    from ocr_inference_tpu_torch.models.recognition import build_recognizer

    rec = build_recognizer("Easter2", len(CHARSET) + 1)
    P.save_params(P.init_recognizer(rec, seed=3), model / "weights.msgpack")
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        img = np.full((40, 300, 3), 230, np.uint8)
        img[10:30, 20: 20 + 60 * (i + 1)] = rng.integers(0, 90, (20, 60 * (
            i + 1), 3))
        cv2.imwrite(str(data / f"l{i}.png"), img)
        (data / f"l{i}.txt").write_text(["ཀ་ག", "ག", "ཀ་ཀ་ག", "ཀ"][i] + "\n",
                                        encoding="utf-8")
    return tmp_path, model, data


def test_bocr_train_equals_the_jax_step_loop(line_job, capsys):
    _bocr_train_against_jax(line_job, capsys)


def test_bocr_train_with_a_line_longer_than_its_frames(line_job, capsys):
    """A label of 80 tokens on a 256-wide canvas (64 frames) has no CTC
    alignment: the JAX step trains on optax's large finite loss, and so
    does the port; every weight it saves is finite."""
    _, _, data = line_job
    (data / "l3.txt").write_text("ཀ་" * 40 + "\n", encoding="utf-8")
    losses, out = _bocr_train_against_jax(line_job, capsys)
    assert max(losses) > 1e3
    weights = P.read_msgpack(out)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(weights))


def _bocr_train_against_jax(line_job, capsys):
    """bocr-train on the CPU and the JAX step loop driven as its CLI
    drives it: the logged losses and the saved weights."""
    from ocr_inference_tpu.cli.train_cli import load_dataset as jax_load
    from ocr_inference_tpu.core.assets import read_ocr_model_config as jcfg
    from ocr_inference_tpu.models import build_recognizer as jbuild
    from ocr_inference_tpu.models.params import load_params as jload
    from ocr_inference_tpu.training import (
        init_train_state, make_optimizer, make_train_step,
    )
    from ocr_inference_tpu_torch.cli import train_cli
    from ocr_inference_tpu_torch.core.assets import read_ocr_model_config
    from ocr_inference_tpu_torch.pipeline.builder import (
        build_recognition_engine,
    )

    root, model, data = line_job
    steps, batch, width = 3, 2, 256
    config = read_ocr_model_config(str(model / "model_config.json"))
    got_data = train_cli.load_dataset(str(data), config, width)
    want_data = jax_load(str(data), jcfg(str(model / "model_config.json")),
                         width)
    for a, b in zip(got_data, want_data):
        np.testing.assert_array_equal(a, b)

    out = root / "weights.msgpack"
    assert train_cli.main([
        "--model", str(model), "--data", str(data), "--output", str(out),
        "--steps", str(steps), "--batch-size", str(batch), "--width",
        str(width), "--log-every", "1", "--device", "cpu"]) == 0
    got = _losses(capsys.readouterr().out)

    images, labels, lengths = want_data
    vocab = len(CHARSET) + 1
    jm = jbuild("Easter2", vocab, dtype=jnp.float32)
    opt = make_optimizer(3e-4, total_steps=steps)
    state = init_train_state(jm, opt, 80, width)
    loaded = jload({"params": state.params, "batch_stats": state.batch_stats},
                   model / "weights.msgpack")
    state.params, state.batch_stats = loaded["params"], loaded["batch_stats"]
    step = make_train_step(jm, opt, None)
    rng = np.random.default_rng(0)
    state_t, want = state.as_tuple(), []
    for _ in range(steps):
        idx = rng.integers(0, len(images), size=batch)
        state_t, loss = step(state_t, {
            "images": images[idx],
            "image_widths": np.full((batch,), width, np.int32),
            "labels": labels[idx], "label_lengths": lengths[idx]})
        want.append(float(loss))
    _close(got, want)

    meta = json.loads((root / "weights.msgpack.json").read_text())
    assert meta == {"architecture": "Easter2", "vocab_size": vocab,
                    "input_height": 80, "trained_steps": steps}
    # the trained weights load into the port's recognizer and the JAX one
    (model / "weights.msgpack").write_bytes(out.read_bytes())
    engine = build_recognition_engine(config, dtype=torch.float32,
                                      device="cpu")
    assert isinstance(engine.run_batch([np.full((40, 200, 3), 128,
                                                np.uint8)])[0], str)
    trained = jload({"params": state_t[0], "batch_stats": state_t[1]}, out)
    assert jax.tree.map(np.shape, trained) == jax.tree.map(
        np.shape, {"params": state_t[0], "batch_stats": state_t[1]})
    return got, out


def _seg_pages(root, classes=None):
    for i in range(2):
        img = np.full((96, 160, 3), 230, np.uint8)
        mask = np.zeros((96, 160), np.uint8)
        img[40:52, 10:150] = 40
        mask[40:52, 10:150] = 255
        cv2.imwrite(str(root / f"p{i}.png"), img)
        if classes is None:
            cv2.imwrite(str(root / f"p{i}_mask.png"), mask)
        else:
            header = np.zeros_like(mask)
            header[5:15, :] = 255
            cv2.imwrite(str(root / f"p{i}_mask_line.png"), mask)
            cv2.imwrite(str(root / f"p{i}_mask_header.png"), header)


def test_bocr_train_seg_equals_the_jax_step_loop(tmp_path, capsys):
    from ocr_inference_tpu.cli.train_seg_cli import load_tiles as jax_tiles
    from ocr_inference_tpu.models import UNet as JUNet
    from ocr_inference_tpu.training import (
        make_optimizer, make_seg_train_step,
    )
    from ocr_inference_tpu_torch.cli import train_seg_cli
    from ocr_inference_tpu_torch.core.data import LineDetectionConfig
    from ocr_inference_tpu_torch.models.segmentation import UNet
    from ocr_inference_tpu_torch.pipeline.builder import build_detection_engine

    _seg_pages(tmp_path)
    (tmp_path / "config.json").write_text(json.dumps({
        "checkpoint": "seg.ckpt", "onnx-model": "seg.onnx",
        "architecture": "unet", "patch_size": 64, "classes": ["line"]}))
    got_tiles = train_seg_cli.load_tiles(str(tmp_path), 64, ["line"])
    want_tiles = jax_tiles(str(tmp_path), 64, ["line"])
    for a, b in zip(got_tiles, want_tiles):
        np.testing.assert_array_equal(a, b)

    steps, batch = 3, 4
    out = tmp_path / "weights.msgpack"
    assert train_seg_cli.main([
        "--config", str(tmp_path / "config.json"), "--data", str(tmp_path),
        "--output", str(out), "--steps", str(steps), "--batch-size",
        str(batch), "--log-every", "1", "--device", "cpu"]) == 0
    got = _losses(capsys.readouterr().out)

    # the JAX loop from the port's initial weights (the CLI's seed 0)
    variables = P.init_segmentation(UNet(classes=1), 64, seed=0)
    jm = JUNet(classes=1, dtype=jnp.float32)
    opt = make_optimizer(3e-4, total_steps=steps)
    step = make_seg_train_step(jm, opt, None)
    state_t = (variables["params"], variables["batch_stats"],
               opt.init(variables["params"]), 0)
    tiles, targets = want_tiles
    rng = np.random.default_rng(0)
    want = []
    for _ in range(steps):
        idx = rng.integers(0, len(tiles), size=batch)
        state_t, loss = step(state_t, {
            "images": tiles[idx].astype(np.float32) / 255.0,
            "targets": targets[idx].astype(np.float32)})
        want.append(float(loss))
    _close(got, want)
    assert not (tmp_path / "weights.msgpack.json").exists()  # no sidecar
    cfg = LineDetectionConfig(checkpoint="", onnx_file=str(
        tmp_path / "weights.onnx"), architecture="unet", patch_size=64,
        classes=["line"])
    engine = build_detection_engine(cfg, dtype=torch.float32, device="cpu")
    assert engine.model.stem_stride == 1  # no sidecar: width 32, stem 1


def test_training_clis_take_a_mesh_of_the_device_type(line_job, tmp_path,
                                                      monkeypatch, capsys):
    """With more than one device of ``--device``'s type (two CPU devices
    here, stubbed: torch has one) bocr-train and bocr-train-seg train on a
    2x1 mesh: the losses the mesh=None CLIs log; a batch that does not
    split over the data axis fails as the JAX step fails."""
    from ocr_inference_tpu_torch.cli import train_cli, train_seg_cli
    from ocr_inference_tpu_torch.parallel import mesh as M

    _, model, data = line_job
    rec = ["--model", str(model), "--data", str(data), "--steps", "2",
           "--width", "256", "--log-every", "1", "--device", "cpu"]
    pages = tmp_path / "pages"
    pages.mkdir()
    _seg_pages(pages)
    (pages / "config.json").write_text(json.dumps({
        "checkpoint": "seg.ckpt", "onnx-model": "seg.onnx",
        "architecture": "unet", "patch_size": 64, "classes": ["line"]}))
    seg = ["--config", str(pages / "config.json"), "--data", str(pages),
           "--steps", "2", "--log-every", "1", "--device", "cpu"]
    runs = []
    for cli, args, batch in ((train_cli, rec, 2), (train_seg_cli, seg, 4)):
        for stub in (False, True):
            if stub:
                monkeypatch.setattr(M, "local_devices",
                                    lambda kind: [torch.device(kind)] * 2)
            out = tmp_path / f"{cli.__name__}{stub}.msgpack"
            assert cli.main(args + ["--output", str(out), "--batch-size",
                                    str(batch)]) == 0
            printed = capsys.readouterr().out
            assert f"training on {2 if stub else 1} device(s)" in printed
            runs.append(_losses(printed))
            monkeypatch.undo()
    for off, on in (runs[:2], runs[2:]):
        _close(on, off)
    monkeypatch.setattr(M, "local_devices",
                        lambda kind: [torch.device(kind)] * 2)
    with pytest.raises(ValueError, match="does not split"):
        train_cli.main(rec + ["--output", str(tmp_path / "x.msgpack"),
                              "--batch-size", "3"])


def test_load_tiles_derives_the_background_as_jax(tmp_path):
    from ocr_inference_tpu.cli.train_seg_cli import load_tiles as jax_tiles
    from ocr_inference_tpu_torch.cli.train_seg_cli import load_tiles

    _seg_pages(tmp_path, classes=["header", "line"])
    classes = ["background", "header", "line"]
    got, want = load_tiles(str(tmp_path), 64, classes), jax_tiles(
        str(tmp_path), 64, classes)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # inside the page every pixel has one class (the padding has none)
    assert (got[1][0].sum(axis=-1) == 1).all()


def test_bocr_selftrain_then_weights_eval_only(tmp_path):
    """selftrain --rec-steps 2 --seg-steps 2 --eval-pages 1, then
    --weights on its directory: eval only, the same per-page CER; the
    EVAL.json keys are the JAX CLI's (run alongside with the same
    arguments)."""
    from ocr_inference_tpu.cli.selftrain_cli import main as jax_main
    from ocr_inference_tpu_torch.cli.selftrain_cli import main

    args = ["--rec-steps", "2", "--seg-steps", "2", "--rec-batch", "2",
            "--seg-batch", "2", "--eval-pages", "1", "--lm-order", "2",
            "--eval-suite", "--canvas-width", "256", "--log-every", "1"]
    out1 = tmp_path / "run1"
    assert main(["--out", str(out1), *args, "--device", "cpu"]) == 0
    r1 = json.loads((out1 / "EVAL.json").read_text())
    assert r1["rec_steps"] == 2 and r1["seg_steps"] == 2
    assert r1["backend"] == "cpu"
    for name in ("recognizer.msgpack", "lines.msgpack"):
        assert (out1 / name).is_file() and P.load_meta(out1 / name)
    assert P.load_meta(out1 / "lines.msgpack") == {
        "architecture": "unet", "width": 32, "stem_stride": 2}

    jout = tmp_path / "jax"
    assert jax_main(["--out", str(jout), *args]) == 0
    want = json.loads((jout / "EVAL.json").read_text())
    assert set(r1) == set(want)
    assert set(r1["provenance"]) == set(want["provenance"])
    assert r1["provenance"]["recognizer_meta"].keys() == \
        want["provenance"]["recognizer_meta"].keys()

    out2 = tmp_path / "run2"
    assert main(["--out", str(out2), "--weights", str(out1),
                 "--eval-pages", "1", "--lm-order", "0", "--eval-suite",
                 "--canvas-width", "256", "--device", "cpu"]) == 0
    r2 = json.loads((out2 / "EVAL.json").read_text())
    assert r2["rec_steps"] == 0 and r2["seg_steps"] == 0
    assert r2["per_page_cer"] == r1["per_page_cer"]


def test_training_clis_need_cuda_unless_cpu_is_asked(line_job, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from ocr_inference_tpu_torch.cli import selftrain_cli, train_cli
    from ocr_inference_tpu_torch.cli import train_seg_cli

    root, model, data = line_job
    (tmp_path / "config.json").write_text(json.dumps({
        "checkpoint": "", "onnx-model": "seg.onnx", "architecture": "unet",
        "patch_size": 64, "classes": ["line"]}))
    for main, argv in (
        (train_cli.main, ["--model", str(model), "--data", str(data),
                          "--output", str(tmp_path / "w.msgpack")]),
        (train_seg_cli.main, ["--config", str(tmp_path / "config.json"),
                              "--data", str(data), "--output",
                              str(tmp_path / "s.msgpack")]),
        (selftrain_cli.main, ["--out", str(tmp_path / "st")]),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)

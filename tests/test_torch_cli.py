"""The port's page-OCR CLI (``python -m ocr_inference_tpu_torch.cli.cli``)
against the JAX ``bocr`` (ocr_inference_tpu/cli/cli.py) on the same pages
and model directory, on the CPU in float32: line-mode texts on PNG pages
and on the same pages as JPEG and TIFF, the artifact and resume flags; and
``--mesh`` against ``--mesh off`` and the JAX ``bocr --mesh 2``; and its
refusals: pages of a variant the port does not decode (a JPEG 2000 TIFF,
a BMP), a ``--mesh`` of more cards than the machine has, and the
``cuda`` default without a card."""

import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.cli import cli as jax_cli
from ocr_inference_tpu.eval.synthetic import WYLIE_CHARSET, GlyphSet, render_page
from ocr_inference_tpu.pipeline.builder import build_pipeline as jax_build
from ocr_inference_tpu_torch.cli import cli
from ocr_inference_tpu_torch.io.artifacts import write_png
from tests import make_refpipe_fixture as fx
from tests.image_writers import jpeg2000_tiff, write_tiff

REPO = Path(__file__).resolve().parents[1]
REFPIPE = REPO / "tests" / "data" / "refpipe"
LAYOUT_SEED = json.loads(
    (REPO / "tests" / "data" / "torch_port" / "layout.json").read_text())["seed"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A model directory (model_config.json and a line config JSON for the
    refpipe weights) and a folder of two PNG pages."""
    root = tmp_path_factory.mktemp("cli")
    model = root / "model"
    model.mkdir()
    (model / "model_config.json").write_text(json.dumps({
        "onnx-model": str(REFPIPE / "recognizer.onnx"),
        "architecture": "Easter2", "input_width": fx.CANVAS,
        "input_height": fx.INPUT_H, "input_layer": "input",
        "output_layer": "output", "squeeze_channel_dim": "yes",
        "swap_hw": "no", "encoder": "wylie", "charset": list(WYLIE_CHARSET),
        "add_blank": "yes", "version": "refpipe"}))
    lines = root / "lines"
    lines.mkdir()
    (lines / "config.json").write_text(json.dumps({
        "checkpoint": "", "onnx-model": str(REFPIPE / "lines.onnx"),
        "architecture": "unet", "patch_size": 512, "classes": ["line"]}))
    pages = root / "pages"
    pages.mkdir()
    glyphs = GlyphSet(height=fx.GLYPH_H, seed=7)
    rng = np.random.RandomState(20_260)
    for i in range(2):
        img = render_page(rng, glyphs, WYLIE_CHARSET, n_lines=(3, 5),
                          page_w=512, align="left",
                          n_syllables=fx.N_SYLLABLES,
                          syllable_len=fx.SYLLABLE_LEN).image
        write_png(pages / f"page{i}.png", img[..., ::-1])  # takes BGR
    return root


def _args(job, out, *extra):
    return ["--model", str(job / "model"), "--folder", str(job / "pages"),
            "--output", str(out), "--line-model", str(job / "lines"),
            *extra]


def _port(job, out, *extra):
    return cli.main(_args(job, out, "--device", "cpu", "--dtype", "float32",
                          *extra))


def _jax(job, out, monkeypatch, *extra):
    monkeypatch.setattr(jax_cli, "build_pipeline",
                        functools.partial(jax_build, dtype=jnp.float32))
    return jax_cli.main(_args(job, out, *extra))


def test_line_mode_texts_equal_jax_cli(job, tmp_path, monkeypatch, capsys):
    assert _port(job, tmp_path / "ours") == 0
    assert _jax(job, tmp_path / "jax", monkeypatch) == 0
    printed = capsys.readouterr().out
    assert printed.count("Text output:") == 4
    for i in range(2):
        got = (tmp_path / "ours" / f"page{i}.txt").read_text(encoding="utf-8")
        want = (tmp_path / "jax" / f"page{i}.txt").read_text(encoding="utf-8")
        assert got == want and got.strip()


def _files(job_dir: Path) -> set[str]:
    return {str(p.relative_to(job_dir)) for p in job_dir.rglob("*")
            if p.is_file()}


def test_artifacts_and_resume(job, tmp_path, monkeypatch, capsys):
    """--save-artifacts writes the JAX CLI's job layout and texts;
    --resume then skips every page, and exits 1 as the JAX CLI does when
    no page was read in the run."""
    flags = ("--save-artifacts", "--artifact-output", str(tmp_path / "art"),
             "--job-id", "ours")
    assert _port(job, tmp_path / "o", *flags) == 0
    jflags = ("--save-artifacts", "--artifact-output", str(tmp_path / "art"),
              "--job-id", "jax")
    assert _jax(job, tmp_path / "j", monkeypatch, *jflags) == 0
    ours, theirs = tmp_path / "art" / "ours", tmp_path / "art" / "jax"
    assert _files(ours) == _files(theirs)
    for i in range(2):
        name = f"page{i}.png/results/page{i}.txt"
        assert (ours / name).read_text(encoding="utf-8") == \
            (theirs / name).read_text(encoding="utf-8")
    capsys.readouterr()
    assert _port(job, tmp_path / "o", *flags, "--resume") == 1
    printed = capsys.readouterr().out
    assert "Resuming: 2 pages already done" in printed
    assert "Text output" not in printed and "OCR failed" not in printed


def test_layout_mode_with_seeded_weights(job, tmp_path):
    """--line-mode layout builds the default layout config's DeepLabV3+;
    with no checkpoint it needs --allow-random-weights, and then reads
    lines with the seeded weights."""
    one = tmp_path / "one"
    one.mkdir()
    (one / "page0.png").write_bytes((job / "pages" / "page0.png").read_bytes())
    base = ["--model", str(job / "model"), "--folder", str(one), "--output",
            str(tmp_path / "out"), "--line-mode", "layout", "--device", "cpu",
            "--dtype", "float32"]
    with pytest.raises(FileNotFoundError, match="allow_random"):
        cli.main(base)
    assert cli.main(base + ["--allow-random-weights", "--seed",
                            str(LAYOUT_SEED)]) == 0
    assert (tmp_path / "out" / "page0.txt").read_text(encoding="utf-8")


def test_jpeg_pages_are_refused_before_any_model_loads(job, tmp_path,
                                                       capsys):
    """A page of a variant the port does not decode (a JPEG 2000 TIFF named
    .jpg) and
    a BMP page are refused by name before any model loads; baseline JPEG
    pages are read (test_jpeg_and_tiff_pages_equal_jax_cli)."""
    folder = tmp_path / "mixed"
    folder.mkdir()
    (folder / "a.png").write_bytes((job / "pages" / "page0.png").read_bytes())
    (folder / "b.jpg").write_bytes(jpeg2000_tiff())
    cv2.imwrite(str(folder / "c.bmp"), np.zeros((8, 8, 3), np.uint8))
    args = ["--model", str(tmp_path / "no_model"), "--output",
            str(tmp_path / "out"), "--device", "cpu"]
    for where, name in ((["--folder", str(folder)], "b.jpg"),
                        (["--image", str(folder / "b.jpg")], "b.jpg"),
                        (["--image", str(folder / "c.bmp")], "c.bmp")):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(args + where)
        message = str(exit_info.value.code)
        assert f"{name} (" in message
        assert ("JPEG 2000 in TIFF" if name == "b.jpg"
                else "BMP images are not supported") in message
    assert not (tmp_path / "out").exists()


def test_jpeg_and_tiff_pages_equal_jax_cli(job, tmp_path, monkeypatch,
                                           capsys):
    """The job's pages as a baseline JPEG, a progressive one with EXIF
    orientation 6 (stored turned a quarter left), an LZW TIFF and a Group
    4 TIFF: the port's texts equal the JAX bocr's on the same files."""
    from PIL import Image

    folder = tmp_path / "formats"
    folder.mkdir()
    page0 = cv2.imread(str(job / "pages" / "page0.png"))
    page1 = cv2.imread(str(job / "pages" / "page1.png"))
    cv2.imwrite(str(folder / "p0.jpg"), page0, [cv2.IMWRITE_JPEG_QUALITY, 92])
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(np.ascontiguousarray(np.rot90(page1[..., ::-1], 1))).save(
        folder / "p1.jpeg", "JPEG", quality=92, progressive=True,
        exif=exif.tobytes())
    Image.fromarray(page0[..., ::-1]).save(folder / "p2.tif",
                                           compression="tiff_lzw")
    Image.fromarray(page1[..., 0]).point(
        lambda v: 255 if v > 128 else 0).convert("1").save(
        folder / "p3.tiff", compression="group4")
    common = ["--model", str(job / "model"), "--folder", str(folder),
              "--line-model", str(job / "lines")]
    assert cli.main(common + ["--output", str(tmp_path / "ours"), "--device",
                              "cpu", "--dtype", "float32"]) == 0
    monkeypatch.setattr(jax_cli, "build_pipeline",
                        functools.partial(jax_build, dtype=jnp.float32))
    assert jax_cli.main(common + ["--output", str(tmp_path / "jax")]) == 0
    assert capsys.readouterr().out.count("Text output:") == 8
    for stem in ("p0", "p1", "p2", "p3"):
        got = (tmp_path / "ours" / f"{stem}.txt").read_text(encoding="utf-8")
        want = (tmp_path / "jax" / f"{stem}.txt").read_text(encoding="utf-8")
        assert got == want and got.strip(), stem


def test_pages_cv2_cannot_read_are_skipped_as_jax_cli(job, tmp_path,
                                                     monkeypatch, capsys):
    """A folder with a readable page, an LZMA TIFF and a float TIFF (cv2's
    libtiff has no LZMA and cannot map float samples): the port's bocr
    and the JAX bocr both exit 0, both print ``Failed to load image`` for
    the two TIFFs, and read the same text from the page. The port used to
    refuse the whole run for them."""
    folder = tmp_path / "skip"
    folder.mkdir()
    (folder / "a.png").write_bytes((job / "pages" / "page0.png").read_bytes())
    write_tiff(folder / "b.tif", [dict(samples=np.zeros((8, 8, 3)), bits=8,
                                       photometric=2, tags={259: 34925})])
    assert cv2.imwrite(str(folder / "c.tiff"),
                       np.zeros((8, 8, 3), np.float32))
    common = ["--model", str(job / "model"), "--folder", str(folder),
              "--line-model", str(job / "lines")]
    assert cli.main(common + ["--output", str(tmp_path / "ours"), "--device",
                              "cpu", "--dtype", "float32"]) == 0
    ours = capsys.readouterr().out
    monkeypatch.setattr(jax_cli, "build_pipeline",
                        functools.partial(jax_build, dtype=jnp.float32))
    assert jax_cli.main(common + ["--output", str(tmp_path / "jax")]) == 0
    theirs = capsys.readouterr().out
    for printed in (ours, theirs):
        for name in ("b.tif", "c.tiff"):
            assert f"Failed to load image: {folder / name}" in printed
        assert printed.count("Text output:") == 1
    got = (tmp_path / "ours" / "a.txt").read_text(encoding="utf-8")
    assert got == (tmp_path / "jax" / "a.txt").read_text(encoding="utf-8")
    assert got.strip()


def test_mesh_is_refused(job, tmp_path, monkeypatch):
    """--mesh asking for more cards than the machine has exits naming the
    count, before anything runs on a card; nothing falls back to the CPU
    (the card count stubbed to 2)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for spec in ("16", "4x4", "3"):
        with pytest.raises(SystemExit) as exit_info:
            cli.main(_args(job, tmp_path / "o", "--mesh", spec))
        assert "this machine has 2" in str(exit_info.value.code)
    assert not (tmp_path / "o").exists()


@pytest.fixture(scope="module")
def mesh_off(job, tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_off")
    assert _port(job, out) == 0
    return out


@pytest.fixture(scope="module")
def jax_mesh_2(job, tmp_path_factory):
    """The JAX bocr --mesh 2 (a 2x1 mesh of the suite's CPU devices)."""
    out = tmp_path_factory.mktemp("jax_mesh")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_cli, "build_pipeline",
                   functools.partial(jax_build, dtype=jnp.float32))
        assert jax_cli.main(_args(job, out, "--mesh", "2")) == 0
    return out


@pytest.mark.parametrize("spec,shape", [
    ("2", {"data": 2, "model": 1}), ("2x2", {"data": 2, "model": 2}),
    ("auto", None)])
def test_mesh_texts_equal_mesh_off_and_jax(job, tmp_path, capsys, mesh_off,
                                           jax_mesh_2, spec, shape):
    """bocr --mesh 2 and 2x2 --device cpu (meshes that repeat the CPU
    device) read every page as --mesh off and as the JAX bocr --mesh 2;
    --mesh auto on the CPU's one device runs on a 1x1 mesh and prints
    none, as the JAX CLI builds none on one device."""
    assert _port(job, tmp_path / "o", "--mesh", spec) == 0
    printed = capsys.readouterr().out
    if shape is None:
        assert "Device mesh" not in printed
    else:
        assert f"Device mesh: {shape}" in printed
    for i in range(2):
        got = (tmp_path / "o" / f"page{i}.txt").read_text(encoding="utf-8")
        assert got.strip()
        assert got == (mesh_off / f"page{i}.txt").read_text(encoding="utf-8")
        assert got == (jax_mesh_2 / f"page{i}.txt").read_text(
            encoding="utf-8")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_mesh_auto_splits_the_folder_across_processes(job, tmp_path,
                                                      mesh_off):
    """Two processes joined by a gloo group from the JAX cluster
    variables, each with one CPU device: bocr --mesh auto counts the
    devices of both, as jax.devices() does (a mesh of 2 is printed), and
    each process reads its half of the folder (host_shard): the halves
    are disjoint, cover every page, and read as --mesh off."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")}
    env["PYTHONPATH"] = str(REPO) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ocr_inference_tpu_torch.cli.cli",
         *_args(job, tmp_path / f"o{i}", "--device", "cpu", "--dtype",
                "float32", "--mesh", "auto")],
        env={**env, "JAX_COORDINATOR_ADDRESS": f"localhost:{port}",
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO))
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a bocr process timed out")
        assert p.returncode == 0, err.decode(errors="replace")[-3000:]
        outs.append(out.decode())
    assert all("Device mesh: {'data': 2, 'model': 1}" in o for o in outs)
    halves = [{f.name for f in (tmp_path / f"o{i}").glob("*.txt")}
              for i in range(2)]
    assert halves == [{"page0.txt"}, {"page1.txt"}]
    for i, half in enumerate(halves):
        for name in half:
            assert (tmp_path / f"o{i}" / name).read_text(encoding="utf-8") \
                == (mesh_off / name).read_text(encoding="utf-8")


def test_cuda_is_the_default_device(job, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(_args(job, tmp_path / "o"))


def test_module_runs_as_a_script(job, tmp_path):
    """python -m ocr_inference_tpu_torch.cli.cli, as a user runs it."""
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "ocr_inference_tpu_torch.cli.cli",
         "--model", str(job / "model"),
         "--image", str(job / "pages" / "page1.png"),
         "--output", str(tmp_path / "o"), "--line-model", str(job / "lines"),
         "--device", "cpu", "--dtype", "float32"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("Text output:") == 1
    assert (tmp_path / "o" / "page1.txt").read_text(encoding="utf-8")

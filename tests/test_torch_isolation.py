"""The port and chip_smoke.py import nothing the card machine lacks, and
the entry points refuse to run without CUDA unless asked for the CPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "cv2", "msgpack", "PIL", "pyarrow",
             "ocr_inference_tpu")

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
{imports}
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in {forbidden!r})
print('FORBIDDEN', bad)
"""


def _imported(imports: str) -> str:
    code = _PROBE.format(repo=str(REPO), imports=imports,
                         forbidden=FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_port_imports_no_jax_cv2_msgpack_or_jax_package():
    imports = (
        "from ocr_inference_tpu_torch.pipeline import build_pipeline\n"
        "import ocr_inference_tpu_torch\n"
        "for m in pkgutil.walk_packages(ocr_inference_tpu_torch.__path__,"
        " 'ocr_inference_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert {'ocr_inference_tpu_torch.parallel.mesh',\n"
        "        'ocr_inference_tpu_torch.parallel.replicas'} <= set(sys.modules)\n"
    )
    assert _imported(imports) == "FORBIDDEN []"


def test_chip_smoke_imports_nothing_forbidden():
    imports = (
        "import chip_smoke\n"
        "from ocr_inference_tpu_torch import native\n"
        "from ocr_inference_tpu_torch.ops import kernels\n"
        "from ocr_inference_tpu_torch.eval import cer, synthetic\n"
    )
    assert _imported(imports) == "FORBIDDEN []"


def test_entry_points_need_cuda_unless_cpu_is_asked(tmp_path):
    from ocr_inference_tpu_torch.device import resolve_device
    from ocr_inference_tpu_torch.pipeline.builder import build_detection_engine
    from ocr_inference_tpu_torch.core.data import LineDetectionConfig

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    cfg = LineDetectionConfig(
        checkpoint="", onnx_file=str(REPO / "tests/data/refpipe/lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_detection_engine(cfg)


def test_chip_smoke_fails_without_cuda_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    shutil.copy2(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout


def test_phase_probe_imports_nothing_forbidden():
    imports = (
        "import probe_binarize_phases\n"
        "from ocr_inference_tpu_torch.ops import kernels\n"
    )
    assert _imported(imports) == "FORBIDDEN []"


def test_volume_probe_imports_nothing_forbidden():
    imports = (
        "import probe_volume\n"
        "from ocr_inference_tpu_torch.pipeline import VolumeRunner\n"
        "from ocr_inference_tpu_torch.io import PageXMLExporter\n"
    )
    assert _imported(imports) == "FORBIDDEN []"


def test_eval_probe_and_dewarp_import_nothing_forbidden():
    """probe_eval.py, the dewarp, the eval suite and the sampler ops, with
    the paths chip_smoke.py's dewarp phases take."""
    imports = (
        "import probe_eval\n"
        "from ocr_inference_tpu_torch import dewarp\n"
        "from ocr_inference_tpu_torch.dewarp import tps\n"
        "from ocr_inference_tpu_torch.eval import suite, synthetic\n"
        "from ocr_inference_tpu_torch.ops.imaging import remap, "
        "remap_linear_u8\n"
        "from ocr_inference_tpu_torch.geometry import "
        "get_line_image_from_mask\n"
    )
    assert _imported(imports) == "FORBIDDEN []"


def test_ab_probe_imports_nothing_forbidden():
    assert _imported("import probe_ab\n") == "FORBIDDEN []"


def test_probe_eval_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "probe_eval.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and '"ok": true' not in proc.stdout


def test_eval_mode_modules_import_nothing_forbidden():
    """Eval mode's modules — the beam searches, the decoder, the ARPA
    scorers, builder and KenLM binaries, the asset helpers — with the
    C++ scorer built and loaded, and the eval suite's LM columns."""
    imports = (
        "from ocr_inference_tpu_torch.decode import (ArpaLM, CTCDecoder,"
        " beam_search)\n"
        "from ocr_inference_tpu_torch.decode import ctc_batch, decoder, "
        "kenlm_binary, kenlm_trie, ngram_builder\n"
        "from ocr_inference_tpu_torch.core import assets\n"
        "from ocr_inference_tpu_torch.native import NativeArpaLM\n"
        "NativeArpaLM({lm!r})\n"
        "from ocr_inference_tpu_torch.eval.suite import (build_eval_lm, "
        "calibrate, lm_columns)\n"
    ).format(lm=str(REPO / "artifacts" / "full77f" / "lm.arpa"))
    assert _imported(imports) == "FORBIDDEN []"


def test_layout_cli_and_reader_import_nothing_forbidden(tmp_path):
    """Layout mode (DeepLabV3+, the modern-book runner), the CLI and the
    PNG reader, with its unfilter built and run."""
    png = tmp_path / "page.png"
    imports = (
        "from ocr_inference_tpu_torch.cli import cli\n"
        "from ocr_inference_tpu_torch.models.segmentation import "
        "DeepLabV3Plus\n"
        "from ocr_inference_tpu_torch.pipeline.modern_layout import "
        "ModernBookFormatLayoutDetection\n"
        "from ocr_inference_tpu_torch.pipeline.builder import "
        "seeded_variables\n"
        "import numpy as np\n"
        "from ocr_inference_tpu_torch.io.artifacts import write_png\n"
        "from ocr_inference_tpu_torch.io.images import read_image\n"
        "write_png({png!r}, np.zeros((4, 4, 3), np.uint8))\n"
        "assert read_image({png!r}).shape == (4, 4, 3)\n"
    ).format(png=str(png))
    assert _imported(imports) == "FORBIDDEN []"


def test_walk_covers_the_serve_and_eval_modules():
    """The walk_packages probe above imports the serving and eval entry
    points, the evaluator, the label encoders and the recognizers."""
    import pkgutil

    import ocr_inference_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        ocr_inference_tpu_torch.__path__, "ocr_inference_tpu_torch.")}
    assert {
        "ocr_inference_tpu_torch.cli.serve_cli",
        "ocr_inference_tpu_torch.cli.evaluate_cli",
        "ocr_inference_tpu_torch.eval.evaluator",
        "ocr_inference_tpu_torch.text.encoders",
        "ocr_inference_tpu_torch.models.recognition",
    } <= names


def _model_dir(tmp_path):
    d = tmp_path / "model"
    d.mkdir()
    (d / "model_config.json").write_text(
        '{"onnx-model": "ocr.onnx", "architecture": "CRNN", "version": "1",'
        ' "input_width": 512, "input_height": 80, "input_layer": "input",'
        ' "output_layer": "output", "encoder": "wylie",'
        ' "squeeze_channel_dim": "yes", "swap_hw": "no",'
        ' "charset": "kg\'abcdefh", "add_blank": "yes"}')
    return d


def test_serve_and_eval_need_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    """bocr-serve, bocr-eval and OCREvaluator default to cuda and raise
    without a card; asked for the CPU they build."""
    import io

    import numpy as np

    from ocr_inference_tpu_torch.cli import evaluate_cli, serve_cli
    from ocr_inference_tpu_torch.eval.evaluator import OCREvaluator
    from ocr_inference_tpu_torch.io.artifacts import write_png

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    model = _model_dir(tmp_path)
    config = str(model / "model_config.json")
    data = tmp_path / "data" / "dist"
    data.mkdir(parents=True)
    write_png(data / "l.png", np.full((50, 120, 3), 230, np.uint8))
    (data / "l.txt").write_text("ka\n")
    monkeypatch.setattr("sys.stdin", io.StringIO("\n"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_cli.main(["--model", str(model), "--allow-random-weights"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cli.main(["--model", str(model), "--dataset",
                           str(tmp_path / "data"), "--output",
                           str(tmp_path / "out"), "--allow-random-weights"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OCREvaluator(config, allow_random=True)
    assert OCREvaluator(config, allow_random=True,
                        device="cpu").get_architecture() == "CRNN"
    assert serve_cli.main(["--model", str(model), "--allow-random-weights",
                           "--device", "cpu"]) == 0


def test_public_surface_modules_are_walked_and_import_nothing_forbidden():
    """ops_host, utils.preview and utils.runtime are in the walk above, and
    drawing a preview, binarizing on the host and taking a profile pull
    in no cv2, JAX or JAX-package module."""
    import pkgutil

    import ocr_inference_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        ocr_inference_tpu_torch.__path__, "ocr_inference_tpu_torch.")}
    assert {
        "ocr_inference_tpu_torch.ops_host",
        "ocr_inference_tpu_torch.utils",
        "ocr_inference_tpu_torch.utils.preview",
        "ocr_inference_tpu_torch.utils.runtime",
    } <= names
    imports = (
        "import numpy as np, tempfile\n"
        "from ocr_inference_tpu_torch import ops_host\n"
        "from ocr_inference_tpu_torch.core.data import BBox\n"
        "from ocr_inference_tpu_torch.utils import (create_preview_image,"
        " draw_bbox, trace_profile)\n"
        "img = np.full((40, 60, 3), 200, np.uint8)\n"
        "cnt = np.array([[[5, 5]], [[30, 5]], [[30, 20]], [[5, 20]]],"
        " np.int32)\n"
        "with trace_profile(tempfile.mkdtemp()):\n"
        "    create_preview_image(img, line_predictions=[cnt])\n"
        "    draw_bbox(img, BBox(1, 1, 20, 10))\n"
        "    ops_host.pad_ocr_line(ops_host.binarize_host(img), 512, 80)\n"
    )
    assert _imported(imports) == "FORBIDDEN []"

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

"""The port's console commands in pyproject.toml: each ``*-torch`` name
resolves to a ``main`` of ocr_inference_tpu_torch/cli/ that, in a fresh
process, imports nothing of JAX or the JAX package and answers --help;
the JAX package's own names stay as they were."""

import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = tomllib.loads((REPO / "pyproject.toml").read_text(
    encoding="utf-8"))["project"]["scripts"]
PORT = {
    "bocr-torch": "cli", "bocr-lines-torch": "infer_lines_cli",
    "bocr-eval-torch": "evaluate_cli", "bocr-serve-torch": "serve_cli",
    "bocr-train-torch": "train_cli", "bocr-train-seg-torch": "train_seg_cli",
    "bocr-selftrain-torch": "selftrain_cli",
    "bocr-inspect-torch": "inspect_onnx_cli",
}
JAX = {
    "bocr": "cli", "bocr-lines": "infer_lines_cli",
    "bocr-download": "download_model_cli", "bocr-eval": "evaluate_cli",
    "bocr-train": "train_cli", "bocr-inspect": "inspect_onnx_cli",
    "bocr-serve": "serve_cli", "bocr-train-seg": "train_seg_cli",
    "bocr-selftrain": "selftrain_cli",
}
FORBIDDEN = ("jax", "flax", "ocr_inference_tpu")

_PROBE = """
import sys
sys.path.insert(0, {repo!r})
module, _, name = {target!r}.partition(':')
main = getattr(__import__(module, fromlist=[name]), name)
assert callable(main)
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})
print('FORBIDDEN', bad)
try:
    main(['--help'])
except SystemExit as e:
    print('EXIT', e.code)
"""


@pytest.mark.parametrize("command", sorted(PORT))
def test_port_command_resolves_to_the_port(command):
    target = SCRIPTS[command]
    assert target == f"ocr_inference_tpu_torch.cli.{PORT[command]}:main"
    code = _PROBE.format(repo=str(REPO), target=target, forbidden=FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert "FORBIDDEN []" in lines, proc.stdout
    assert lines[-1] == "EXIT 0", proc.stdout[-500:]
    assert "usage:" in proc.stdout


def test_jax_commands_are_unchanged():
    for command, module in JAX.items():
        assert SCRIPTS[command] == f"ocr_inference_tpu.cli.{module}:main"
    assert set(SCRIPTS) == set(JAX) | set(PORT)

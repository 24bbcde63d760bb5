"""Every public name of the JAX package resolves in the port.

An ``ast`` walk over ``ocr_inference_tpu/``: each module's top-level
functions, classes and assignments, and each ``__init__``'s imports from
the package, must resolve in the port's module of the same dotted name;
every ``from ocr_inference_tpu... import X`` line of ``examples/*.py`` must
resolve with ``ocr_inference_tpu_torch`` in its place. Only the port is
imported.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "ocr_inference_tpu"

# left out of the port, each with its reason in ROADMAP.md section 3
NOT_PORTED_MODULES = {
    "ops.pallas_kernels": "its counterpart is ops/kernels.py; the rest "
                          "guards Mosaic compiles",
    "models.torch_twins": "the JAX package's PyTorch validation scaffold",
    "cli.download_model_cli": "a download function: fetches over the network",
    "cli.download_all_models": "a download function: fetches over the network",
}
NOT_PORTED_NAMES = {
    ("core.assets", "download_model"): "fetches over the network",
    ("core.assets", "download_kenlm"): "fetches over the network",
    ("dewarp.tps", "host_warp_pair_vertical"): "the port always warps on "
                                               "the card",
}


def _modules() -> list[str]:
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _source(module: str) -> Path:
    base = JAX_PKG.joinpath(*module.split(".")) if module else JAX_PKG
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


def public_names(module: str) -> list[str]:
    """Top-level public definitions of a JAX module; for a package's
    ``__init__`` also the names it imports from the package."""
    path = _source(module)
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.level > 0 or (node.module or "").startswith(
                  "ocr_inference_tpu"))):
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


PORTED = [m for m in _modules() if m not in NOT_PORTED_MODULES]


def test_the_walk_sees_the_whole_package():
    mods = set(_modules())
    assert {"", "ops_host", "utils", "utils.preview", "utils.runtime",
            "core.data", "geometry.lines", "parallel.mesh"} <= mods
    assert len(mods) > 70
    assert set(NOT_PORTED_MODULES) <= mods


@pytest.mark.parametrize("module", PORTED)
def test_every_public_name_resolves_in_the_port(module):
    port = importlib.import_module(
        "ocr_inference_tpu_torch" + (f".{module}" if module else ""))
    missing = [n for n in public_names(module)
               if (module, n) not in NOT_PORTED_NAMES
               and not hasattr(port, n)]
    assert missing == []


def test_parallel_offers_the_jax_mesh_runtime():
    """The port's ``parallel`` offers every name the JAX
    ``parallel/__init__.py`` imports, and ``parallel.mesh`` every public
    name of the JAX ``mesh.py``."""
    port = importlib.import_module("ocr_inference_tpu_torch.parallel")
    mesh = importlib.import_module("ocr_inference_tpu_torch.parallel.mesh")
    init_names = public_names("parallel")
    mesh_names = public_names("parallel.mesh")
    assert {"DataParallelRunner", "host_shard", "make_mesh",
            "distributed_init", "tp_shardings"} <= set(init_names)
    assert "shard_params_tp" in mesh_names
    assert [n for n in init_names if not hasattr(port, n)] == []
    assert [n for n in mesh_names if not hasattr(mesh, n)] == []


@pytest.mark.parametrize("module, name", sorted(NOT_PORTED_NAMES))
def test_names_left_out_exist_in_jax_and_not_in_the_port(module, name):
    assert name in public_names(module)
    port = importlib.import_module(f"ocr_inference_tpu_torch.{module}")
    assert not hasattr(port, name)


def _example_imports(path: Path) -> list[tuple[str, str]]:
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "ocr_inference_tpu"):
            out += [(node.module, a.name) for a in node.names]
    return out


EXAMPLES = sorted((REPO / "examples").glob("*.py"))


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda p: p.name)
def test_every_example_import_resolves_in_the_port(example):
    imports = _example_imports(example)
    assert imports
    for module, name in imports:
        port = importlib.import_module(
            module.replace("ocr_inference_tpu", "ocr_inference_tpu_torch", 1))
        assert hasattr(port, name), f"{module}.{name}"


def test_the_three_example_scripts_are_walked():
    names = {p.name for p in EXAMPLES}
    assert {"demo_ocr.py", "line_inference.py", "modern_layout.py"} <= names
    got = {n for p in EXAMPLES for _, n in _example_imports(p)}
    assert {"enable_compilation_cache", "create_preview_image",
            "save_ocr_lines_parquet", "ModernBookFormatLayoutDetection",
            "import_local_model", "build_detection_engine"} <= got

"""The port's exporters, artifact manager, artifact runner and geometry
helpers against the JAX package's on the same inputs."""

import copy
import json
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu import geometry as jgeo
from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.io import artifacts as jartifacts
from ocr_inference_tpu.io import exporter as jexporter
from ocr_inference_tpu.pipeline.builder import build_pipeline as jax_build
from ocr_inference_tpu.pipeline.runner import (
    run_ocr_with_artifacts as jax_run_with_artifacts,
)
from ocr_inference_tpu_torch import geometry as geo
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.io import artifacts, exporter
from ocr_inference_tpu_torch.pipeline import (
    build_pipeline,
    run_ocr_with_artifacts,
)
from tests.test_torch_pipeline import _refpipe_configs

FIXED_TIME = "2026-01-02T03:04:05"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _polygon(rng, cx, cy, n):
    """A star-shaped (N, 1, 2) int32 polygon around (cx, cy)."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(5, 60, n)
    pts = np.stack([cx + r * np.cos(angles), cy + r * np.sin(angles)], -1)
    return pts.round().astype(np.int32).reshape(-1, 1, 2)


def _records(mod, seed):
    """(lines, ocr_lines) for one page, built in ``mod``'s data classes from
    one seed (guids are not part of any exported file)."""
    rng = np.random.default_rng(seed)
    lines, ocr_lines = [], []
    for i in range(int(rng.integers(2, 6))):
        cnt = _polygon(rng, int(rng.integers(100, 900)), 80 + 120 * i,
                       int(rng.integers(4, 30)))
        x, y, w, h = cv2.boundingRect(cnt)
        lines.append(mod.Line(guid=mod.generate_guid(clock_seq=23),
                              contour=cnt, bbox=mod.BBox(x, y, w, h),
                              center=(x + w // 2, y + h // 2)))
        text = ["bkra shis", "<&> \"q\"", "", "ཀ་ཁ"][i % 4]
        ocr_lines.append(mod.OCRLine(guid=lines[-1].guid, text=text,
                                     encoding="UNICODE"))
    return lines, ocr_lines


@pytest.fixture
def fixed_time(monkeypatch):
    monkeypatch.setattr(exporter, "get_utc_time", lambda: FIXED_TIME)
    monkeypatch.setattr(jexporter, "get_utc_time", lambda: FIXED_TIME)


@pytest.mark.parametrize("cls", ["PageXMLExporter", "TextExporter",
                                 "JsonExporter"])
@pytest.mark.parametrize("kwargs", [{}, {"angle": 1.7}, {"bbox": True},
                                    {"optimize": False, "angle": -3.0}])
def test_exporter_files_equal_jax(tmp_path, fixed_time, cls, kwargs):
    image = np.zeros((1200, 1000), np.uint8)
    for seed in range(3):
        (tmp_path / "port").mkdir(exist_ok=True)
        (tmp_path / "jax").mkdir(exist_ok=True)
        lines, ocr_lines = _records(data, seed)
        jlines, jocr = _records(jdata, seed)
        kw = {} if cls == "TextExporter" and kwargs else kwargs
        got = getattr(exporter, cls)(str(tmp_path / "port")).export_lines(
            image, f"page{seed}", copy.deepcopy(lines), ocr_lines, **kw)
        want = getattr(jexporter, cls)(str(tmp_path / "jax")).export_lines(
            image, f"page{seed}", copy.deepcopy(jlines), jocr, **kw)
        assert Path(got).name == Path(want).name
        assert Path(got).read_bytes() == Path(want).read_bytes()


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 1), (40, 29, 3)])
def test_artifact_png_reads_back_as_cv2_file(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    ours = artifacts.ArtifactManager(str(tmp_path), job_id="port")
    theirs = jartifacts.ArtifactManager(str(tmp_path), job_id="jax")
    got = cv2.imread(str(ours.save_image("mask", img, "detection")),
                     cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(theirs.save_image("mask", img, "detection")),
                      cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    assert [e["type"] for e in ours.manifest] == ["image"]


def test_artifact_png_rejects_what_it_cannot_write(tmp_path):
    ours = artifacts.ArtifactManager(str(tmp_path), job_id="port")
    with pytest.raises(TypeError):
        ours.save_image("f", np.zeros((4, 4), np.float32), "detection")
    with pytest.raises(ValueError):
        ours.save_image("rgba", np.zeros((4, 4, 4), np.uint8), "detection")
    with pytest.raises(ValueError):
        ours.save_image("j", np.zeros((4, 4), np.uint8), "detection", "jpg")


def _tree(job_dir: Path) -> dict:
    """Relative path -> comparable content of every file of a job (json
    without timestamps and guids, images decoded, text as is)."""
    out = {}
    for path in sorted(job_dir.rglob("*")):
        if not path.is_file():
            continue
        rel = str(path.relative_to(job_dir))
        if path.suffix == ".png":
            out[rel] = cv2.imread(str(path), cv2.IMREAD_UNCHANGED).tolist()
        elif path.suffix == ".json":
            doc = json.loads(path.read_text(encoding="utf-8"))
            for line in doc.get("lines", []) if isinstance(doc, dict) else []:
                if isinstance(line, dict):
                    line.pop("guid", None)
            doc.pop("created", None)
            for entry in doc.get("artifacts", []):
                entry.pop("timestamp")
                entry["path"] = str(Path(entry["path"]).relative_to(job_dir))
            for timed in (doc.get("job_summary", {}),
                          doc.get("per_page_metrics", {}).get("page", {})):
                for key in ("total_duration_ms", "avg_duration_per_page_ms"):
                    timed.pop(key, None)
            out[rel] = doc
        elif path.suffix == ".log":
            out[rel] = [
                {k: v for k, v in json.loads(line).items()
                 if k not in ("timestamp", "job_id")}
                for line in path.read_text(encoding="utf-8").splitlines()
            ]
        else:
            out[rel] = path.read_text(encoding="utf-8")
    return out


def test_run_ocr_with_artifacts_writes_what_jax_writes(tmp_path, fixed_time):
    from tests.test_torch_pipeline import fx  # refpipe page geometry
    from ocr_inference_tpu.eval.synthetic import (
        WYLIE_CHARSET, GlyphSet, render_page,
    )

    ours = build_pipeline(*_refpipe_configs(data), dtype=torch.float32,
                          device="cpu")
    theirs = jax_build(*_refpipe_configs(jdata), dtype=jnp.float32)
    page = render_page(np.random.RandomState(20_260),
                       GlyphSet(height=fx.GLYPH_H, seed=7), WYLIE_CHARSET,
                       n_lines=(3, 5), page_w=512, align="left",
                       n_syllables=fx.N_SYLLABLES,
                       syllable_len=fx.SYLLABLE_LEN).image
    trees = []
    for mod, am_mod, run, pipe in (
        (data, artifacts, run_ocr_with_artifacts, ours),
        (jdata, jartifacts, jax_run_with_artifacts, theirs),
    ):
        root = tmp_path / mod.__name__.split(".")[0]
        manager = am_mod.ArtifactManager(str(root), job_id="job")
        manager.set_current_page("page")
        audit = am_mod.AuditLogger("job", root / "job" / "audit.log")
        status, result = run(
            pipe, page, "page", artifact_manager=manager, audit_logger=audit,
            artifact_config=mod.ArtifactConfig(),
            target_encoding=mod.Encoding.WYLIE,
        )
        assert status.name == "SUCCESS", result
        manager.save_aggregate_metrics()
        manager.generate_manifest()
        for handler in audit.logger.handlers:
            handler.close()
        trees.append(_tree(root / "job"))
    got, want = trees
    assert sorted(got) == sorted(want)
    assert "page/results/page.xml" in got and "manifest.json" in got
    for rel in want:
        assert got[rel] == want[rel], rel


# ---------------------------------------------------------------------------
# Geometry helpers on seeded random inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_geometry_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    cnt = _polygon(rng, 400, 300, 25)
    for center, angle in (((400, 300), 1.3), ((500, 640), -2.7),
                          ((0, 0), 90.0), ((123, 77), 0.0)):
        np.testing.assert_array_equal(
            geo.rotate_contour(cnt, center, angle),
            jgeo.rotate_contour(cnt, center, angle))
    lines, _ = _records(data, seed)
    jlines, _ = _records(jdata, seed)
    assert geo.get_text_bbox(lines).as_tuple() == \
        jgeo.get_text_bbox(jlines).as_tuple()
    contours = [ln.contour for ln in lines]
    bbox, rot = geo.get_union_bbox(contours)
    jbbox, jrot = jgeo.get_union_bbox(contours)
    assert bbox.as_tuple() == jbbox.as_tuple()
    assert (rot.center, rot.width, rot.height, rot.angle) == \
        (jrot.center, jrot.width, jrot.height, jrot.angle)
    np.testing.assert_array_equal(rot.points, jrot.points)
    assert geo.get_union_bbox([]) == jgeo.get_union_bbox([]) == (None, None)
    from ocr_inference_tpu.geometry import lines as jlines_mod

    pts = [tuple(p) for p in cnt[:, 0].tolist()]
    sx, sy = rng.uniform(0.3, 3.0, 2)
    np.testing.assert_array_equal(geo.contour_to_cv(pts),
                                  jlines_mod.contour_to_cv(pts))
    assert geo.contour_to_original(pts, sx, sy) == \
        jlines_mod.contour_to_original(pts, sx, sy)
    box = tuple(int(v) for v in rng.integers(0, 900, 4))
    assert geo.bbox_to_original(box, sx, sy) == \
        jlines_mod.bbox_to_original(box, sx, sy)


def _peak_mask(rng, channels):
    h, w = 700, 900
    mask = np.zeros((h, w, 3), np.uint8)
    y = 30
    while y < h - 60:
        lh = int(rng.integers(20, 45))
        x0 = int(rng.integers(0, 200))
        color = rng.integers(1, 256, 3)
        mask[y: y + lh, x0: x0 + int(rng.integers(300, 700))] = color
        y += lh + int(rng.integers(8, 60))
    return mask if channels == 3 else cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("seed", range(3))
def test_sort_lines_by_peaks_matches_jax(seed, channels):
    rng = np.random.default_rng(100 + seed)
    mask = _peak_mask(rng, channels)
    gray = mask if channels == 1 else cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY)
    if channels == 3:
        np.testing.assert_array_equal(geo.lines.bgr_to_gray(mask), gray)
    contours = [c for c in jgeo.get_contours((gray > 0).astype(np.uint8))
                if cv2.contourArea(c) > 10]
    for group in (True, False):
        got, gap = geo.sort_lines_by_peaks(
            mask, [geo.build_line_data(c) for c in contours], group)
        want, jgap = jgeo.sort_lines_by_peaks(
            mask, [jgeo.build_line_data(c) for c in contours], group)
        assert gap == jgap
        assert [(ln.bbox.as_tuple(), ln.center, ln.contour.tolist())
                for ln in got] == \
            [(ln.bbox.as_tuple(), ln.center, ln.contour.tolist())
             for ln in want]
    assert geo.sort_lines_by_peaks(mask, []) == ([], 0.0)


def test_bgr_to_gray_is_cv2_on_random_pixels():
    img = np.random.default_rng(9).integers(0, 256, (64, 80, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(geo.lines.bgr_to_gray(img),
                                  cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(geo.lines.bgr_to_gray(img[:, ::-1]),
                                  cv2.cvtColor(np.ascontiguousarray(
                                      img[:, ::-1]), cv2.COLOR_BGR2GRAY))

"""The port's standard-library Parquet writer and reader (io/parquet.py)
against the JAX package's pyarrow ones, its ImageInferenceDataset
(io/dataset.py) and its ``bocr-lines`` (cli/infer_lines_cli.py) against
the JAX ones on a mixed-format folder, on the CPU in float32: the same
Parquet schema and rows (pyarrow reads the port's files), the same items,
and the refusals."""

import functools
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
from PIL import Image

from ocr_inference_tpu.cli import infer_lines_cli as jax_cli
from ocr_inference_tpu.io import dataset as jax_dataset
from ocr_inference_tpu.io import parquet as jax_parquet
from ocr_inference_tpu.pipeline.builder import (
    build_detection_engine as jax_build_detection,
)
from ocr_inference_tpu_torch.cli import infer_lines_cli as cli
from ocr_inference_tpu_torch.core.config import (
    LINE_DETECTION_SCHEMA,
    OCR_LINES_SCHEMA,
)
from ocr_inference_tpu_torch.io import parquet
from ocr_inference_tpu_torch.io.dataset import ImageInferenceDataset
from tests.image_writers import jpeg2000_tiff
from tests.make_torch_port_fixture import OUT, REPO, WEIGHTS

LINES = REPO / "tests" / "data" / "refpipe" / "lines.msgpack"

RESULTS = [
    {"image_name": "page.png", "image_width": 1024, "image_height": 700,
     "num_contours": 2, "contours": [[(1, 2), (3, 4), (5, 9)], [(7, 8)]],
     "bboxes": [(1, 2, 5, 8), (7, 8, 1, 1)]},
    {"image_name": "empty.tif", "image_width": 5, "image_height": 6,
     "num_contours": 0, "contours": [], "bboxes": []},
    {"image_name": "ཀ་ཁ ünïcode.jpg", "image_width": 2**31 - 1,
     "image_height": -3, "num_contours": 3, "contours": [[], [(0, 0)], []],
     "bboxes": [(0, 0, 0, 0)]},
]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_schemas_are_the_jax_ones():
    from ocr_inference_tpu.core import config as jax_config

    def arrow(typ):
        if isinstance(typ, str):
            return typ.replace("string", "string").replace("float32", "float")
        if typ[0] == "list":
            return f"list<element: {arrow(typ[1])}>"
        return "struct<" + ", ".join(f"{n}: {arrow(t)}"
                                     for n, t in typ[1]) + ">"

    for ours, theirs in ((LINE_DETECTION_SCHEMA,
                          jax_config.LINE_DETECTION_SCHEMA),
                         (OCR_LINES_SCHEMA, jax_config.OCR_LINES_SCHEMA)):
        assert [n for n, _ in ours] == theirs.names
        for (_, typ), field in zip(ours, theirs):
            want = str(field.type).replace("item: ", "element: ")
            assert arrow(typ) == want
            assert field.nullable


@pytest.mark.parametrize("result", RESULTS, ids=["page", "empty", "unicode"])
@pytest.mark.parametrize("compression", ["gzip", "none"])
def test_write_result_parquet_equals_jax(tmp_path, result, compression):
    ours = parquet.write_result_parquet(result, tmp_path / "ours",
                                        compression=compression)
    theirs = jax_parquet.write_result_parquet(result, tmp_path / "jax")
    assert os.path.basename(ours) == os.path.basename(theirs)
    assert pq.ParquetFile(ours).schema.equals(pq.ParquetFile(theirs).schema)
    assert pq.read_table(ours).to_pylist() == pq.read_table(theirs) \
        .to_pylist()
    assert parquet.read_result_parquet(ours) == \
        jax_parquet.read_result_parquet(ours) == \
        jax_parquet.read_result_parquet(theirs)
    meta = pq.ParquetFile(ours).metadata.row_group(0).column(0)
    assert meta.compression == ("GZIP" if compression == "gzip"
                                else "UNCOMPRESSED")


class _Line:
    def __init__(self, i, logits, lm_scores, ctc_conf):
        self.guid, self.text = f"guid-{i}", ["", "ka kha", "ཀ་ཁ"][i % 3]
        self.encoding = "wylie"
        self.ctc_conf, self.norm_logp = ctc_conf, -0.25 * i
        self.logits, self.lm_scores = logits, lm_scores


@pytest.mark.parametrize("n", [0, 1, 5])
def test_save_ocr_lines_parquet_equals_jax(tmp_path, n):
    rng = np.random.default_rng(n)
    lines = []
    for i in range(n):
        k = int(rng.integers(0, 4))
        logits = [float(v) for v in rng.normal(size=k)] if i % 4 else None
        lm = [] if i % 3 == 2 else [float(v) for v in rng.normal(size=k)]
        lines.append(_Line(i, logits, lm,
                           None if i == 3 else float(rng.random())))
    ours, theirs = tmp_path / "ours.parquet", tmp_path / "jax.parquet"
    parquet.save_ocr_lines_parquet(lines, ours)
    jax_parquet.save_ocr_lines_parquet(lines, theirs)
    assert pq.ParquetFile(ours).schema.equals(pq.ParquetFile(theirs).schema)
    assert pq.read_table(ours).to_pylist() == pq.read_table(theirs) \
        .to_pylist()
    assert parquet.read_table(ours) == pq.read_table(ours).to_pylist()


def test_zstd_and_other_encodings_are_refused_by_name(tmp_path):
    path = jax_parquet.write_result_parquet(RESULTS[0], tmp_path)
    with pytest.raises(NotImplementedError, match="zstd"):
        parquet.read_result_parquet(path)
    table = pq.read_table(path)
    pq.write_table(table, tmp_path / "dict.parquet", compression="none")
    with pytest.raises(NotImplementedError, match="DICTIONARY"):
        parquet.read_result_parquet(tmp_path / "dict.parquet")


def _page(rng, h, w):
    """A light page with dark text-like bars, so detection finds lines."""
    img = rng.integers(215, 250, (h, w, 3), dtype=np.uint8)
    for y in range(40, h - 40, 60):
        x0 = int(rng.integers(20, 60))
        img[y: y + 22, x0: w - 40] = rng.integers(15, 70, (22, w - 40 - x0,
                                                           3))
    return img


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A mixed-format folder: PNG, JPEG (baseline and progressive), TIFF
    (LZW and Group 4), a file of another extension, an unreadable .jpg."""
    root = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(11)
    cv2.imwrite(str(root / "a.png"), _page(rng, 300, 420))
    cv2.imwrite(str(root / "b.jpg"), _page(rng, 260, 500),
                [cv2.IMWRITE_JPEG_QUALITY, 90])
    cv2.imwrite(str(root / "C.JPEG"), _page(rng, 333, 377),
                [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    Image.fromarray(_page(rng, 280, 400)).save(root / "d.tif",
                                               compression="tiff_lzw")
    Image.fromarray(_page(rng, 300, 512)[..., 0]).point(
        lambda v: 255 if v > 128 else 0).convert("1").save(
        root / "e.tiff", compression="group4")
    (root / "notes.txt").write_text("not an image")
    (root / "broken.jpg").write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00")
    return root


@pytest.mark.parametrize("mode", ["rgb", "bgr"])
def test_dataset_items_equal_jax(folder, mode):
    ours = ImageInferenceDataset(str(folder), mode=mode)
    theirs = jax_dataset.ImageInferenceDataset(str(folder), mode=mode)
    assert ours.paths == theirs.paths and len(ours) == len(theirs) == 6
    for i, path in enumerate(ours.paths):
        if path.endswith("broken.jpg"):
            with pytest.raises(IOError):
                ours[i]
            with pytest.raises(IOError):
                theirs[i]
            continue
        (a, ma), (b, mb) = ours.get_item(i), theirs.get_item(i)
        np.testing.assert_array_equal(a, b)
        assert ma == mb


def test_dataset_prefetch_yields_in_order(folder, tmp_path):
    readable = tmp_path / "readable"
    readable.mkdir()
    for p in folder.iterdir():
        if p.name != "broken.jpg":
            (readable / p.name).write_bytes(p.read_bytes())
    ours = ImageInferenceDataset(str(readable))
    theirs = jax_dataset.ImageInferenceDataset(str(readable))
    got = list(ours.iter_prefetched(num_workers=3))
    want = list(theirs.iter_prefetched(num_workers=3))
    assert len(got) == len(want) == 5
    for (a, ma), (b, mb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert ma == mb


def test_bocr_lines_rows_equal_jax(folder, tmp_path, monkeypatch, capsys):
    """Both CLIs over the mixed folder with the same line model in float32:
    one Parquet file per readable page, with the same schema and rows."""
    monkeypatch.setattr(jax_cli, "build_detection_engine", functools.partial(
        jax_build_detection, dtype=jnp.float32))
    assert jax_cli.main(["-i", str(folder), "-o", str(tmp_path / "jax"),
                         "-c", str(LINES), "--device", "cpu", "-b", "2",
                         "-w", "2"]) == 0
    assert cli.main(["-i", str(folder), "-o", str(tmp_path / "ours"),
                     "-c", str(LINES), "--device", "cpu", "--dtype",
                     "float32", "-b", "2", "-w", "2"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("Failed to load image") == 2
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert len(names) == 5
    lines_found = 0
    for name in names:
        ours, theirs = tmp_path / "ours" / name, tmp_path / "jax" / name
        assert pq.ParquetFile(ours).schema.equals(
            pq.ParquetFile(theirs).schema)
        assert pq.read_table(ours).to_pylist() == \
            pq.read_table(theirs).to_pylist()
        lines_found += parquet.read_result_parquet(ours)["num_contours"]
    assert lines_found > 0


def test_bocr_lines_refusals(folder, tmp_path):
    """Without a card the default device raises; an empty folder exits 1;
    a variant the port does not decode stops the run, naming it."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["-i", str(folder), "-o", str(tmp_path / "o"),
                      "-c", str(LINES)])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["-i", str(empty), "-c", str(LINES), "--device", "cpu"])
    assert exit_info.value.code == 1
    refused = tmp_path / "refused"
    refused.mkdir()
    (refused / "x.jpg").write_bytes(jpeg2000_tiff(64, 64))
    with pytest.raises(NotImplementedError, match="JPEG 2000 in TIFF"):
        cli.main(["-i", str(refused), "-o", str(tmp_path / "a"),
                  "-c", str(LINES), "--device", "cpu"])


def test_bocr_lines_over_the_committed_pages_equals_jax_record(tmp_path):
    """The encoded fixture pages (tests/data/torch_port/images/pages) with
    the full77f line model in float32: every row equal to the JAX
    bocr-lines row images.json records, as chip_smoke.py checks on the
    card."""
    record = json.loads((OUT / "images.json").read_text(encoding="utf-8"))
    assert cli.main(["-i", str(OUT / "images" / "pages"), "-o",
                     str(tmp_path), "-c", str(WEIGHTS / "lines.msgpack"),
                     "--device", "cpu", "--dtype", "float32"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        sorted(record["bocr_lines"])
    for name, want in record["bocr_lines"].items():
        got = parquet.read_result_parquet(tmp_path / name)
        got["contours"] = [[list(p) for p in c] for c in got["contours"]]
        got["bboxes"] = [list(b) for b in got["bboxes"]]
        assert got == want, name

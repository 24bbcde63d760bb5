"""The committed fixture pages (tests/data/torch_port/images/pages) through
the port's ``bocr-lines`` with the full77f line model in float32, split by
format into groups that run in test files of their own (pytest-xdist's
``--dist loadfile`` gives each file one worker): every row equal to the
JAX bocr-lines row images.json records, as chip_smoke.py checks on the
card. bocr-lines globs the JAX CLI's five extensions, so the pages of the
other formats go through it under the names the record gives them
(chip_smoke.renamed_page)."""

import json
from pathlib import Path

import torch

from chip_smoke import globbed_by_folder, renamed_page
from ocr_inference_tpu_torch.cli import infer_lines_cli as cli
from ocr_inference_tpu_torch.io import parquet
from tests.make_torch_port_fixture import OUT, WEIGHTS

PAGES = OUT / "images" / "pages"
# suffixes of each group's page files
GROUPS = {
    "jpeg_png_gif_webp": (".jpg", ".jpeg", ".png", ".gif", ".webp"),
    "tiff": (".tif", ".tiff"),
    "jp2_bmp_pnm_raster": (".jp2", ".j2k", ".jph", ".bmp", ".pgm", ".ppm",
                           ".pam", ".ras", ".pfm", ".hdr"),
    "avif": (".avif",),
}


def record() -> dict:
    return json.loads((OUT / "images.json").read_text(encoding="utf-8"))


def group_of(path: Path) -> str | None:
    for group, suffixes in GROUPS.items():
        if path.suffix.lower() in suffixes:
            return group
    return None


def folder_name(path: Path) -> str:
    """The name a page file takes in the folder bocr-lines runs over."""
    return path.name if globbed_by_folder(path) else renamed_page(path.name)


def parquet_name(path: Path) -> str:
    return folder_name(path).rsplit(".", 1)[0] + ".parquet"


def pages(group: str) -> list[Path]:
    return sorted(p for p in PAGES.iterdir() if group_of(p) == group)


def check_group(group: str, tmp_path: Path) -> None:
    """bocr-lines over one group's pages in one folder: its Parquet files
    are the record's for those pages, row for row."""
    want = record()["bocr_lines"]
    folder = tmp_path / "pages"
    folder.mkdir()
    for path in pages(group):
        (folder / folder_name(path)).write_bytes(path.read_bytes())
    out = tmp_path / "out"
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert cli.main(["-i", str(folder), "-o", str(out), "-c",
                         str(WEIGHTS / "lines.msgpack"), "--device", "cpu",
                         "--dtype", "float32"]) == 0
    finally:
        torch.set_num_threads(threads)
    names = sorted(parquet_name(p) for p in pages(group))
    assert names and sorted(p.name for p in out.iterdir()) == names
    for name in names:
        got = parquet.read_result_parquet(out / name)
        got["contours"] = [[list(p) for p in c] for c in got["contours"]]
        got["bboxes"] = [list(b) for b in got["bboxes"]]
        assert got == want[name], name

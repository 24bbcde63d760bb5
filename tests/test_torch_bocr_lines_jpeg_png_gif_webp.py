"""bocr-lines over the committed JPEG, PNG, GIF and WebP pages against the
JAX record (tests/torch_committed_pages.py)."""

from tests.torch_committed_pages import check_group


def test_bocr_lines_over_the_committed_pages_equals_jax_record(tmp_path):
    """Every JPEG, PNG, GIF and WebP page's Parquet rows equal the JAX
    bocr-lines rows images.json records."""
    check_group("jpeg_png_gif_webp", tmp_path)


def test_the_groups_cover_the_record():
    """The groups' pages are every committed page, each in one group, and
    their Parquet names are the record's whole key set."""
    from tests.torch_committed_pages import (
        GROUPS, PAGES, pages, parquet_name, record)

    files = sorted(PAGES.iterdir())
    grouped = [p for g in GROUPS for p in pages(g)]
    assert sorted(grouped) == files
    assert sorted(parquet_name(p) for p in grouped) == \
        sorted(record()["bocr_lines"])

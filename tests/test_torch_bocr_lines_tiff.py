"""bocr-lines over the committed TIFF pages against the JAX record
(tests/torch_committed_pages.py)."""

from tests.torch_committed_pages import check_group


def test_bocr_lines_over_the_committed_pages_equals_jax_record(tmp_path):
    """Every TIFF page's Parquet rows equal the JAX bocr-lines rows
    images.json records."""
    check_group("tiff", tmp_path)

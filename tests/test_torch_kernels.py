"""The port's binarize kernel wrappers against the JAX Pallas kernels and
cv2.

On the CPU the wrappers run their plain PyTorch versions, which must be
bit-exact with cv2.adaptiveThreshold and with ``binarize_tiles_pallas`` /
``binarize_lines_pallas`` (run in interpret mode, as
tests/test_pallas_engines.py runs them) wherever those equal cv2. The
kernels' two-tier decision (float32 blur, exact recheck in cv2's float32
arithmetic near the threshold) is held here in its plain rendering,
``binarize_two_tier``; the CUDA kernels themselves are held against the
plain version on the card (the ``cuda``-marked test; chip_smoke.py
phase 2).
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.ops import pallas_kernels as pk
from ocr_inference_tpu_torch.ops import imaging, kernels


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _page_like(rng, shape):
    img = np.full(shape, 235, np.uint8)
    h, w = shape[1], shape[2]
    x0 = min(40, w // 4)
    for y in range(h // 8, max(h - 30, h // 8 + 1), max(h // 4, 31)):
        band = img[:, y: y + 26, x0: w - x0]
        band[...] = rng.integers(20, 70, band.shape)
    noise = rng.integers(-10, 10, shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _cv2_binarize(gray: np.ndarray) -> np.ndarray:
    return np.stack([cv2.adaptiveThreshold(
        g, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 51, 13)
        for g in gray])


def _assert_follows_cv2_where_pallas_departs(got, want, cv):
    """The port equals cv2 everywhere, and the Pallas kernel wherever the
    Pallas kernel equals cv2. The Pallas kernels' blur (banded matmuls at
    the highest precision) departs from cv2's float32 mean on knife-edge
    pixels whose mean rounds the other way; there the port follows cv2,
    as the JAX package's host binarize and training batches do."""
    np.testing.assert_array_equal(got, cv)
    agree = want == cv
    np.testing.assert_array_equal(got[agree], want[agree])
    assert (~agree).sum() <= 4, int((~agree).sum())


@pytest.mark.parametrize("h,w", [(1, 127), (2, 20), (5, 1), (23, 37),
                                 (80, 61), (81, 333), (57, 2500)])
def test_plain_blur_is_cv2_float32_blur(h, w):
    """blur_cv2 equals cv2.GaussianBlur of the float image (51x51,
    BORDER_REPLICATE | BORDER_ISOLATED, what adaptiveThreshold blurs) bit
    for bit, its vector and scalar column tails and the one-row and
    one-column images included, and the plain version equals
    cv2.adaptiveThreshold."""
    g = np.random.default_rng(h * w).integers(0, 256, (h, w), dtype=np.uint8)
    want = cv2.GaussianBlur(g.astype(np.float32), (51, 51), 0,
                            borderType=cv2.BORDER_REPLICATE
                            | cv2.BORDER_ISOLATED)
    got = imaging.blur_cv2(torch.from_numpy(g)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        imaging.adaptive_threshold_gaussian(torch.from_numpy(g)).numpy(),
        _cv2_binarize(g[None])[0])


@pytest.mark.parametrize("kind", ["random", "page"])
def test_tiles_plain_matches_pallas_tile_kernel(kind):
    rng = np.random.default_rng(1)
    shape = (2, 512, 512, 3)
    t = (rng.integers(0, 256, shape, dtype=np.uint8) if kind == "random"
         else _page_like(rng, shape))
    want = np.asarray(pk.binarize_tiles_pallas(jnp.asarray(t)))
    got = kernels.binarize_tiles(torch.from_numpy(t)).numpy()
    cv = _cv2_binarize(imaging.rgb_to_gray(torch.from_numpy(t)).numpy())
    _assert_follows_cv2_where_pallas_departs(got, want, cv)


@pytest.mark.parametrize("width", [512, 1024, 2000])
def test_lines_plain_matches_pallas_line_kernel(width):
    rng = np.random.default_rng(width)
    g = rng.integers(0, 256, (2, 80, width), dtype=np.uint8)
    want = np.asarray(pk.binarize_lines_pallas(jnp.asarray(g)))
    got = kernels.binarize_lines(torch.from_numpy(g)).numpy()
    _assert_follows_cv2_where_pallas_departs(got, want, _cv2_binarize(g))


@pytest.mark.parametrize("shape", [(80, 512), (80, 2500), (80, 3000),
                                   (512, 512), (80, 51), (57, 333)])
def test_plain_matches_cv2_adaptive_threshold(shape):
    rng = np.random.default_rng(sum(shape))
    for g in (rng.integers(0, 256, shape, dtype=np.uint8),
              _page_like(rng, (1,) + shape)[0]):
        want = cv2.adaptiveThreshold(
            g, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 51, 13
        )
        got = kernels.binarize_lines(torch.from_numpy(g)[None]).numpy()[0]
        np.testing.assert_array_equal(got, want)


def test_tiles_fuse_cv2_gray_conversion():
    rng = np.random.default_rng(5)
    t = rng.integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    gray = cv2.cvtColor(t[0], cv2.COLOR_RGB2GRAY)
    want = cv2.adaptiveThreshold(
        gray, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY, 51, 13
    )
    got = kernels.binarize_tiles(torch.from_numpy(t)).numpy()[0]
    np.testing.assert_array_equal(got, want)


def test_cpu_path_counts_no_launch_and_checks_shapes():
    kernels.reset_launches()
    kernels.binarize_lines(torch.zeros((1, 80, 64), dtype=torch.uint8))
    kernels.binarize_tiles(torch.zeros((1, 64, 64, 3), dtype=torch.uint8))
    assert kernels.LAUNCHES == {"binarize_tiles": 0, "binarize_lines": 0}
    with pytest.raises(ValueError):
        kernels.binarize_tiles(torch.zeros((1, 64, 64), dtype=torch.uint8))
    with pytest.raises(ValueError):
        kernels.binarize_lines(torch.zeros((80, 64), dtype=torch.uint8))


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "page":
        return _page_like(rng, shape)
    return kernels.knife_edge_gray(*shape, seed=seed)


TWO_TIER_CASES = [(kind, shape) for kind in ("random", "page", "knife")
                  for shape in ((2, 256, 256), (3, 80, 777))]


@pytest.mark.parametrize("kind,shape", TWO_TIER_CASES)
def test_float32_blur_within_recheck_eps(kind, shape):
    """The kernels' float32 blur stays within RECHECK_EPS (2**-8) of the
    plain version's (cv2's float32 order); each lies within the derived
    1.56e-3 of the exact sum, and the measured distance (at most 1.5e-4)
    sits under 2**-12, 16x inside RECHECK_EPS."""
    g = torch.from_numpy(_inputs(kind, shape, 3))
    _, _, err = kernels.binarize_two_tier(g)
    assert err < 1.56e-3
    assert err < kernels.RECHECK_EPS / 16, err


@pytest.mark.parametrize("kind,shape", TWO_TIER_CASES)
def test_two_tier_decision_equals_plain_version(kind, shape):
    g = torch.from_numpy(_inputs(kind, shape, 4))
    got, rechecked, _ = kernels.binarize_two_tier(g)
    np.testing.assert_array_equal(
        got.numpy(), kernels.binarize_lines_plain(g).numpy())
    if kind == "knife":  # every window centre goes through the recheck
        b, h, w = shape
        centres = b * len(range(26, h - 25, 52)) * len(range(26, w - 25, 52))
        assert rechecked >= centres


def test_knife_edge_windows_sit_on_the_threshold():
    """Every window's blurred centre is within 1e-4 of centre + 12.5, on
    both sides, by the plain version's float64 formula."""
    wins = kernels.knife_edge_windows(64, 0)
    g = torch.from_numpy(wins.copy())
    acc = imaging.blur_in_order(g, torch.float64)[:, 25, 25].numpy()
    d = acc - (wins[:, 25, 25].astype(np.float64) + 12.5)
    assert np.abs(d).max() < 1e-4
    assert (d > 0).any() and (d < 0).any()
    assert (wins[:, 25, 25] < 243).all()
    tiled = kernels.knife_edge_gray(1, 512, 512)
    np.testing.assert_array_equal(tiled[0, 1:52, 1:52], wins[0])
    np.testing.assert_array_equal(tiled[0, 1:52, 53:104], wins[1])
    np.testing.assert_array_equal(tiled[0, 53:104, 1:52], wins[9])


def test_line_strip_width_covers_a_wave():
    assert kernels.line_strip_width(64, 80, 3000, 132) == 128
    assert kernels.line_strip_width(8, 80, 1024, 132) == 32
    assert kernels.line_strip_width(12, 80, 1024, 132) == 64
    assert kernels.line_strip_width(1, 80, 100, 132) == 32
    assert kernels.line_strip_width(2, 200, 4000, 132) == 128


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """Both specialisations against the plain version: random tiles and
    canvases at every width bucket, an odd width (1601), a canvas lower
    than 80 rows and a tile shape off the 512 grid; on the knife-edge
    inputs the exact tier must run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernel has no CPU mode)")
    rng = np.random.default_rng(2)
    dev = torch.device("cuda")
    knife = kernels.knife_edge_gray(4, 512, 512)
    tile_inputs = [
        (rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8), False),
        (np.repeat(knife[..., None], 3, axis=-1), True),
        (rng.integers(0, 256, (2, 300, 333, 3), dtype=np.uint8), False),
    ]
    line_inputs = [(rng.integers(0, 256, (8, 80, w), dtype=np.uint8), False)
                   for w in (512, 1024, 2000, 2500, 3000, 1601)]
    line_inputs += [(rng.integers(0, 256, (3, 57, 999), dtype=np.uint8), False),
                    (kernels.knife_edge_gray(8, 80, 1601), True)]
    before = dict(kernels.LAUNCHES)
    for fn, plain, inputs in (
        (kernels.binarize_tiles, kernels.binarize_tiles_plain, tile_inputs),
        (kernels.binarize_lines, kernels.binarize_lines_plain, line_inputs),
    ):
        for x, knife_edge in inputs:
            x = torch.from_numpy(x).to(dev)
            kernels.reset_rechecked()
            got = fn(x)
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          plain(x).cpu().numpy())
            if knife_edge:
                assert sum(kernels.rechecked().values()) > 0
    assert kernels.LAUNCHES["binarize_tiles"] == before["binarize_tiles"] + 3
    assert kernels.LAUNCHES["binarize_lines"] == before["binarize_lines"] + 8


def test_phase_probe_stamps_the_kernel_source():
    """probe_binarize_phases.py finds each of its anchors once in the
    kernel source, so it times the kernel that ships."""
    import probe_binarize_phases as probe

    out = probe.instrumented((kernels.CSRC_DIR / "binarize.cu").read_text())
    assert out.count("const unsigned long long t") == 3
    assert "g_stamp[bid][3] = stamp();" in out
    assert "int stamps_read(void* host)" in out


def test_first_use_setup_runs_once_across_threads(monkeypatch):
    """A volume run launches the kernels from two threads: the per-device
    set-up (constant taps, SM count, recheck counters) runs once however
    many threads reach it together. The library is a stub here."""
    import sys
    import threading
    import time
    from types import SimpleNamespace

    calls = []

    class StubLibrary:
        def ocr_binarize_init(self, taps_ptr):
            calls.append(taps_ptr)
            time.sleep(0.05)  # widen the window a second caller could use
            return 0

    monkeypatch.setattr(kernels, "_library", StubLibrary)
    monkeypatch.setattr(kernels, "_READY", set())
    monkeypatch.setattr(kernels, "_COUNTERS", {})
    monkeypatch.setattr(kernels, "_SMS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    dev = torch.device("cpu")  # a stand-in: the stub touches no card
    barrier = threading.Barrier(8)
    libs = []

    def worker():
        barrier.wait(timeout=30)
        libs.append(kernels._ready(dev))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(libs) == 8
    assert kernels._SMS == {None: 132}
    assert sorted(kernels._COUNTERS) == [("binarize_lines", None),
                                         ("binarize_tiles", None)]

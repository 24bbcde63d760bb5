"""Synthetic pecha pages without OpenCV, for the port's checks on the card.

A copy of ocr_inference_tpu/eval/synthetic.py's page generator
(``sample_tokens``, ``MarkovSampler``, ``render_line_strip``,
``render_page``, ``degrade_page``, ``distort_page``): the same
``np.random.RandomState`` calls in the same order, so the same seed gives
the same page bytes. The glyph bitmaps, which the JAX package draws with
cv2, come from the caller (the committed fixture
``tests/data/torch_port/pages.npz`` stores them packed). cv2's pixel calls
are replaced by byte-equal code: RGB2GRAY by ``rgb_to_gray``, the filled
``cv2.circle`` by ``fill_circle``, ``cv2.remap`` by ``remap_linear_u8``
and the page rotation by the port's warpAffine.

``curved_volume`` is a copy of bench.py's ``make_curved_volume`` (bench.py
config 2, the dewarped volume).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ocr_inference_tpu_torch.ops.imaging import (
    remap_linear_u8,
    rgb_to_gray,
    rotation_matrix,
    warp_affine,
)

PAPER = 235


def sample_tokens(rng: np.random.RandomState, charset, n_syllables=(4, 10),
                  syllable_len=(1, 4)) -> list[str]:
    """Random token sequence with "§" separators between syllables."""
    units = [t for t in charset if t != "§"]
    out: list[str] = []
    for s in range(int(rng.randint(*n_syllables))):
        if s:
            out.append("§")
        for _ in range(int(rng.randint(syllable_len[0], syllable_len[1] + 1))):
            out.append(units[int(rng.randint(len(units)))])
    return out


class MarkovSampler:
    """Token sampler with real n-gram structure, a sparse first-order chain
    (eval/synthetic.py:129-175): each token allows only ``fanout``
    successors, fixed per seed, the first drawn about half of the time."""

    def __init__(self, charset, fanout: int = 4, seed: int = 1234):
        self.charset = charset
        units = [t for t in charset if t != "§"]
        self.units = units
        rng = np.random.RandomState(seed)
        self.successors = {}
        w = np.array([2.0 ** -i for i in range(fanout)])
        self.weights = w / w.sum()
        for tok in ["<s>"] + units:
            idx = rng.permutation(len(units))[:fanout]
            self.successors[tok] = [units[i] for i in idx]

    def __call__(self, rng: np.random.RandomState, charset=None,
                 n_syllables=(4, 10), syllable_len=(1, 4)) -> list[str]:
        out: list[str] = []
        prev = "<s>"
        for s in range(int(rng.randint(*n_syllables))):
            if s:
                out.append("§")
            for _ in range(
                int(rng.randint(syllable_len[0], syllable_len[1] + 1))
            ):
                succ = self.successors[prev]
                prev = succ[int(rng.choice(len(succ), p=self.weights))]
                out.append(prev)
        return out


def tokens_to_text(tokens: list[str]) -> str:
    """Ground truth in the pipeline's convention ("§" becomes a space)."""
    return "".join(tokens).replace("§", " ").strip()


def render_line_strip(tokens, glyphs: dict, rng: np.random.RandomState,
                      gap=(2, 7)) -> np.ndarray:
    """One text line as an RGB strip: light noisy paper, dark ink."""
    h = next(iter(glyphs.values())).shape[0]
    parts: list[np.ndarray] = []
    for tok in tokens:
        parts.append(glyphs[tok])
        parts.append(np.zeros((h, int(rng.randint(*gap))), np.uint8))
    ink = np.concatenate(parts[:-1] if len(parts) > 1 else parts, axis=1)
    w = ink.shape[1]
    strip = rng.randint(215, 250, (h, w, 3)).astype(np.uint8)
    dark = rng.randint(15, 70, (h, w, 3)).astype(np.uint8)
    sel = ink > 0
    strip[sel] = dark[sel]
    return strip


def render_page(rng: np.random.RandomState, glyphs: dict, charset,
                n_lines=(4, 7), page_w=1024, margin=48, gap=(50, 90),
                n_syllables=(4, 10), syllable_len=(1, 4),
                align="random") -> tuple[np.ndarray, list[str]]:
    """A pecha-like page -> (RGB uint8 image, per-line texts in reading
    order); eval/synthetic.py render_page with uniform token sampling."""
    h_line = next(iter(glyphs.values())).shape[0]
    n = int(rng.randint(*n_lines))
    pitch = h_line + int(rng.randint(*gap))
    page_h = 2 * margin + n * pitch
    page = rng.randint(215, 250, (page_h, page_w, 3)).astype(np.uint8)
    texts: list[str] = []
    max_w = page_w - 2 * margin
    for i in range(n):
        tokens = sample_tokens(rng, charset, n_syllables, syllable_len)
        strip = render_line_strip(tokens, glyphs, rng)
        while strip.shape[1] > max_w and len(tokens) > 2:
            tokens = tokens[: max(len(tokens) - 3, 2)]
            if tokens and tokens[-1] == "§":
                tokens = tokens[:-1]
            strip = render_line_strip(tokens, glyphs, rng)
        y0 = margin + i * pitch + int(rng.randint(-3, 4))
        if align == "left":
            x0 = margin + int(rng.randint(0, 9))
        else:
            x0 = margin + int(rng.randint(0, max(max_w - strip.shape[1], 1)))
        sh, sw = strip.shape[:2]
        page[y0: y0 + sh, x0: x0 + sw] = strip
        texts.append(tokens_to_text(tokens))
    return page, texts


def rotate_page(image: np.ndarray, deg: float) -> np.ndarray:
    """The rotation of distort_page: about the page center, paper-colored
    border."""
    h, w = image.shape[:2]
    m = rotation_matrix((w / 2.0, h / 2.0), deg)
    return warp_affine(torch.from_numpy(image), m, h, w, PAPER).numpy()


def circle_spans(radius: int) -> list[tuple[int, int, int]]:
    """The rows of cv2's filled circle (its ``Circle`` midpoint routine,
    LINE_8, no shift): (dy, dx_lo, dx_hi) spans about the center, which
    overlap where cv2 draws a row twice."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    spans = []
    while dx >= dy:
        spans += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy), (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        step = 0 if err <= 0 else -1
        err -= minus & step
        dx += step
        minus -= step & 2
    return spans


def fill_circle(image: np.ndarray, center: tuple[int, int], radius: int,
                color) -> None:
    """In place: cv2.circle(image, center, radius, color, -1), clipped at
    the image edges as cv2 clips it."""
    h, w = image.shape[:2]
    cx, cy = center
    for dy, lo, hi in circle_spans(radius):
        y = cy + dy
        if 0 <= y < h:
            x0, x1 = max(cx + lo, 0), min(cx + hi, w - 1)
            if x0 <= x1:
                image[y, x0: x1 + 1] = color


def degrade_page(image: np.ndarray, rng: np.random.RandomState,
                 level: float) -> np.ndarray:
    """Ink dropout (paper-colored holes punched into the strokes) plus dark
    speckle (eval/synthetic.py:178-209); level 0 is the identity."""
    if level <= 0:
        return image
    img = image.copy()
    h, w = img.shape[:2]
    gray = rgb_to_gray(torch.from_numpy(img)).numpy()
    ink = gray < 128
    ys, xs = np.nonzero(ink)
    if len(ys):
        n_holes = int(len(ys) * level / 60)
        sel = rng.randint(0, len(ys), size=n_holes)
        r = 2 + int(level * 3)
        for i in sel:
            y, x = int(ys[i]), int(xs[i])
            fill_circle(img, (x, y), int(rng.randint(1, r + 1)), PAPER)
    n_specks = int(h * w * level / 4000)
    for _ in range(n_specks):
        y = int(rng.randint(0, h - 2))
        x = int(rng.randint(0, w - 2))
        img[y: y + 2, x: x + 2] = int(rng.randint(20, 70))
    return img


def distort_page(image: np.ndarray, rng: np.random.RandomState,
                 shear_deg: float = 0.0, curve_amp: float = 0.0
                 ) -> np.ndarray:
    """A horizontal sine curve of ``curve_amp`` px (cv2.remap with a
    paper-colored border), then a whole-page rotation by ``shear_deg``
    with a random sign (eval/synthetic.py:212-245)."""
    img = image
    h, w = img.shape[:2]
    if curve_amp > 0:
        xs = np.arange(w, dtype=np.float32)
        dy = curve_amp * np.sin(xs * (2.0 * np.pi / (w * 0.9)))
        map_x = np.broadcast_to(xs, (h, w)).astype(np.float32)
        map_y = (
            np.arange(h, dtype=np.float32)[:, None] + dy[None, :]
        ).astype(np.float32)
        img = remap_linear_u8(torch.from_numpy(img), torch.from_numpy(map_x),
                              torch.from_numpy(map_y), PAPER).numpy()
    if shear_deg != 0.0:
        deg = float(shear_deg) * (1 if int(rng.randint(2)) else -1)
        img = rotate_page(img, deg)
    return img


# bench.py's page size and line count (bench.py:39-41)
BENCH_PAGE_H, BENCH_PAGE_W, BENCH_LINES = 1600, 2640, 8


def curved_volume(n_pages: int) -> list[np.ndarray]:
    """bench.py config 2's pages (bench.py:399-418, seed 7): noisy paper and
    eight dark bands bent by a 40 px sine, so the TPS gate trips."""
    rng = np.random.default_rng(7)
    pages = []
    xs = np.arange(BENCH_PAGE_W - 200)
    for _ in range(n_pages):
        img = np.full((BENCH_PAGE_H, BENCH_PAGE_W, 3), 235, np.uint8)
        noise = rng.integers(-12, 12, size=img.shape)
        img = np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)
        step = BENCH_PAGE_H // (BENCH_LINES + 1)
        wave = (40 * np.sin(xs / (BENCH_PAGE_W / 6.0))).astype(int)
        for i in range(BENCH_LINES):
            y0 = step * (i + 1)
            for dx, dy in zip(xs, wave):
                img[y0 + dy: y0 + dy + 36, 100 + dx] = 45
        pages.append(img)
    return pages


def pack_glyphs(glyphs: dict) -> dict[str, np.ndarray]:
    """{token: (h, w) 0/255 bitmap} -> npz-ready arrays."""
    tokens = sorted(glyphs)
    widths = np.array([glyphs[t].shape[1] for t in tokens], np.int32)
    bits = np.concatenate([glyphs[t] > 0 for t in tokens], axis=1)
    return {
        "glyph_tokens": np.array(tokens),
        "glyph_widths": widths,
        "glyph_bits": np.packbits(bits, axis=1),
        "glyph_total_w": np.array(bits.shape[1]),
    }


def unpack_glyphs(npz) -> dict[str, np.ndarray]:
    total = int(npz["glyph_total_w"])
    bits = np.unpackbits(npz["glyph_bits"], axis=1)[:, :total]
    out, x = {}, 0
    for tok, w in zip(npz["glyph_tokens"], npz["glyph_widths"]):
        out[str(tok)] = (bits[:, x: x + w] * 255).astype(np.uint8)
        x += int(w)
    return out


def load_glyphs(path: str | Path) -> tuple[dict[str, np.ndarray], list[str]]:
    """The glyph bitmaps and charset stored in ``pages.npz``:
    ``GlyphSet(WYLIE_CHARSET_FULL, height=40, seed=7)`` of the JAX package,
    the set its eval suite renders with (cli/selftrain_cli.py:148)."""
    with np.load(path) as npz:
        return unpack_glyphs(npz), [str(t) for t in npz["charset"]]


def fixture_pages(path: str | Path) -> list[tuple[str, np.ndarray, list[str]]]:
    """Rebuild the pages of ``tests/data/torch_port/pages.npz`` ->
    [(name, RGB page, ground-truth line texts)]. A rotated page is the
    port's rotation of its clean page, which is byte-equal with the cv2
    rotation the fixture was made with."""
    with np.load(path) as npz:
        glyphs = unpack_glyphs(npz)
        charset = [str(t) for t in npz["charset"]]
        pages = []
        for i, name in enumerate(npz["names"]):
            rng = np.random.RandomState(int(npz["seeds"][i]))
            img, texts = render_page(rng, glyphs, charset)
            deg = float(npz["rotations"][i])
            if deg != 0.0:
                img = rotate_page(img, deg)
            pages.append((str(name), img, texts))
    return pages

"""Synthetic pecha pages and training batches without OpenCV.

A copy of ocr_inference_tpu/eval/synthetic.py: the page generator
(``sample_tokens``, ``MarkovSampler``, ``render_line_strip``,
``render_page``, ``degrade_page``, ``distort_page``), the glyph set
(``GlyphSet``) and the training half (``extraction_matched_strip``,
``recognizer_batch``, ``segmentation_batch``), with the same
``np.random.RandomState`` calls in the same order, so the same seed gives
the same pages and batches. cv2's pixel calls are replaced by byte-equal
code: the glyphs' thick lines, arcs and filled circles by ops/drawing.py,
RGB2GRAY by ``rgb_to_gray``, ``cv2.remap`` by ``remap_linear_u8``, the
page rotation by the port's warpAffine, and the training batches'
``cv2.adaptiveThreshold`` by the binarize kernels on the card
(``binarize_lines`` on the recognizer canvases, ``binarize_tiles`` on the
segmentation tiles).

The page functions take a ``GlyphSet`` or a {token: bitmap} dict (the
committed fixture ``tests/data/torch_port/pages.npz`` stores the bitmaps
packed).

``curved_volume`` is a copy of bench.py's ``make_curved_volume`` (bench.py
config 2, the dewarped volume).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ocr_inference_tpu_torch.device import resolve_device
from ocr_inference_tpu_torch.ops import drawing, kernels
from ocr_inference_tpu_torch.ops.drawing import fill_circle
from ocr_inference_tpu_torch.ops.imaging import (
    remap_linear_u8,
    rgb_to_gray,
    rotation_matrix,
    warp_affine,
)
from ocr_inference_tpu_torch.ops.tiling import pad_ocr_line

PAPER = 235

# the 35 base Wylie units, the JAX generator's default charset
# (eval/synthetic.py:27)
WYLIE_CHARSET: tuple[str, ...] = (
    "k", "kh", "g", "ng", "c", "ch", "j", "ny", "t", "th", "d", "n",
    "p", "ph", "b", "m", "ts", "tsh", "dz", "w", "zh", "z", "'", "y",
    "r", "l", "sh", "s", "h", "a", "i", "u", "e", "o", "§",
)

# the 77-unit charset of the published recognizers' size
# (eval/synthetic.py:39-55): the base units, retroflex letters and the
# common subjoined and superscribed stacks
WYLIE_CHARSET_FULL: tuple[str, ...] = WYLIE_CHARSET + (
    "T", "Th", "D", "N", "Sh",
    "kr", "khr", "gr", "pr", "phr", "br", "mr",
    "ky", "khy", "gy", "py", "phy", "by", "my",
    "rk", "rg", "rng", "rj", "rny", "rt", "rd", "rn", "rb", "rm",
    "rts", "rdz",
    "sk", "sg", "sng", "sny", "st", "sd", "sn", "sp", "sb", "sm", "sts",
)


def _token_rng(token: str, seed: int) -> np.random.RandomState:
    digest = hashlib.sha256(f"{seed}:{token}".encode()).digest()
    return np.random.RandomState(int.from_bytes(digest[:4], "little"))


@dataclass
class GlyphSet:
    """One deterministic glyph bitmap per charset token
    (eval/synthetic.py:62-103): a head line and 2-4 random strokes (lines,
    arcs, verticals) drawn from a generator seeded by the token and
    ``seed``; the tsheg "§" is a small high dot."""

    charset: tuple[str, ...] = WYLIE_CHARSET
    height: int = 40
    seed: int = 7
    _cache: dict = field(default_factory=dict)

    def glyph(self, token: str) -> np.ndarray:
        """Ink mask (h, w) uint8 in {0, 255} for one token."""
        got = self._cache.get(token)
        if got is not None:
            return got
        rng = _token_rng(token, self.seed)
        h = self.height
        if token == "§":
            w = max(h // 5, 4)
            g = np.zeros((h, w), np.uint8)
            fill_circle(g, (w // 2, h // 4), max(w // 3, 1), 255)
        else:
            w = int(rng.randint(h // 2, h))
            g = np.zeros((h, w), np.uint8)
            drawing.line(g, (1, 3), (w - 2, 3), 255, 2)
            for _ in range(int(rng.randint(2, 5))):
                kind = rng.randint(0, 3)
                x0, x1 = int(rng.randint(0, w)), int(rng.randint(0, w))
                y0, y1 = int(rng.randint(3, h)), int(rng.randint(3, h))
                t = int(rng.randint(2, 4))
                if kind == 0:
                    drawing.line(g, (x0, y0), (x1, y1), 255, t)
                elif kind == 1:
                    drawing.ellipse(
                        g, (w // 2, (y0 + y1) // 2),
                        (max(w // 3, 2), max(abs(y1 - y0) // 2, 2)),
                        0, 0, int(rng.randint(180, 360)), 255, t,
                    )
                else:
                    drawing.line(g, (x0, 3), (x0, y1), 255, t)
        self._cache[token] = g
        return g


def _glyph(glyphs, token: str) -> np.ndarray:
    return glyphs.glyph(token) if isinstance(glyphs, GlyphSet) else \
        glyphs[token]


def _glyph_height(glyphs) -> int:
    return glyphs.height if isinstance(glyphs, GlyphSet) else \
        next(iter(glyphs.values())).shape[0]


def sample_tokens(rng: np.random.RandomState, charset=WYLIE_CHARSET,
                  n_syllables=(4, 10),
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

    def __init__(self, charset=WYLIE_CHARSET, fanout: int = 4,
                 seed: int = 1234):
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


def render_line_strip(tokens, glyphs, rng: np.random.RandomState,
                      gap=(2, 7)) -> np.ndarray:
    """One text line as an RGB strip: light noisy paper, dark ink."""
    h = _glyph_height(glyphs)
    parts: list[np.ndarray] = []
    for tok in tokens:
        parts.append(_glyph(glyphs, tok))
        parts.append(np.zeros((h, int(rng.randint(*gap))), np.uint8))
    ink = np.concatenate(parts[:-1] if len(parts) > 1 else parts, axis=1)
    w = ink.shape[1]
    strip = rng.randint(215, 250, (h, w, 3)).astype(np.uint8)
    dark = rng.randint(15, 70, (h, w, 3)).astype(np.uint8)
    sel = ink > 0
    strip[sel] = dark[sel]
    return strip


@dataclass
class SyntheticPage:
    image: np.ndarray           # (H, W, 3) uint8
    line_mask: np.ndarray       # (H, W) uint8 {0, 255}
    texts: list[str]            # per line, reading order, pipeline convention
    token_lines: list[list[str]]


def render_page(rng: np.random.RandomState, glyphs, charset=WYLIE_CHARSET,
                n_lines=(4, 7), page_w=1024, margin=48, gap=(50, 90),
                n_syllables=(4, 10), syllable_len=(1, 4), align="random",
                token_sampler=None) -> SyntheticPage:
    """A pecha-like page (eval/synthetic.py:279-337): stacked text lines,
    light paper, dark ink, with the line mask (one solid rectangle per
    line), the per-line texts in reading order and their tokens.
    ``token_sampler`` (default ``sample_tokens``; a ``MarkovSampler``
    gives markov text) draws each line's tokens as ``sampler(rng, charset,
    n_syllables, syllable_len)``."""
    h_line = _glyph_height(glyphs)
    n = int(rng.randint(*n_lines))
    pitch = h_line + int(rng.randint(*gap))
    page_h = 2 * margin + n * pitch
    page = rng.randint(215, 250, (page_h, page_w, 3)).astype(np.uint8)
    mask = np.zeros((page_h, page_w), np.uint8)
    texts: list[str] = []
    token_lines: list[list[str]] = []
    sampler = token_sampler or sample_tokens
    max_w = page_w - 2 * margin
    for i in range(n):
        tokens = sampler(rng, charset, n_syllables, syllable_len)
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
        mask[y0: y0 + sh, x0: x0 + sw] = 255
        texts.append(tokens_to_text(tokens))
        token_lines.append(tokens)
    return SyntheticPage(page, mask, texts, token_lines)


def rotate_page(image: np.ndarray, deg: float) -> np.ndarray:
    """The rotation of distort_page: about the page center, paper-colored
    border."""
    h, w = image.shape[:2]
    m = rotation_matrix((w / 2.0, h / 2.0), deg)
    return warp_affine(torch.from_numpy(image), m, h, w, PAPER).numpy()


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
            page = render_page(rng, glyphs, charset)
            img, texts = page.image, page.texts
            deg = float(npz["rotations"][i])
            if deg != 0.0:
                img = rotate_page(img, deg)
            pages.append((str(name), img, texts))
    return pages


# the line dataset of the eval CLI's checks: two distributions, clean lines
# and the eval suite's degrade_03 ink dropout (cli/selftrain_cli.py:485)
LINE_DISTRIBUTIONS = (("clean", 0.0), ("degrade_03", 0.3))


def line_dataset(glyphs: dict, charset, seed: int = 11, per_dist: int = 24
                 ) -> dict[str, list[tuple[str, np.ndarray, str]]]:
    """{distribution: [(name, RGB line image, label)]}: rendered lines of
    2-5 syllables with 40-70 px of paper on each side (a strip the
    page pipeline cuts around a 40 px glyph line is about 150 px tall), so
    that the images' heights vary from 120 to 180 px, degraded as
    ``LINE_DISTRIBUTIONS`` says. A label is the line's tokens in the
    recognizer's Wylie units with the "§" tsheg, which ``WylieEncoder``
    reads back unchanged (a random stack's Unicode would not come back as
    the same units)."""
    rng = np.random.RandomState(seed)
    out = {}
    for dist, level in LINE_DISTRIBUTIONS:
        lines = []
        for i in range(per_dist):
            tokens = sample_tokens(rng, charset, n_syllables=(2, 6))
            strip = render_line_strip(tokens, glyphs, rng)
            top, bottom, left, right = (int(v) for v in
                                        rng.randint(40, 71, size=4))
            h, w = strip.shape[:2]
            img = rng.randint(215, 250, (top + h + bottom, left + w + right,
                                         3)).astype(np.uint8)
            img[top: top + h, left: left + w] = strip
            # paper within +-5 gray levels: the evaluator binarizes the
            # whole line before the recognizer's own binarize, and paper
            # noise wider than the threshold's 13 levels turns into specks
            paper = rgb_to_gray(torch.from_numpy(img)).numpy() >= 128
            img[paper] = rng.randint(228, 239, (int(paper.sum()), 3))
            img = degrade_page(img, rng, level)
            lines.append((f"line{i:02d}", img, "".join(tokens)))
        out[dist] = lines
    return out


def write_line_dataset(root: str | Path, dataset: dict) -> None:
    """``line_dataset`` as the eval CLI reads it: ROOT/<distribution>/
    <name>.png with <name>.txt holding the label."""
    from ocr_inference_tpu_torch.io.artifacts import write_png

    for dist, lines in dataset.items():
        folder = Path(root) / dist
        folder.mkdir(parents=True, exist_ok=True)
        for name, img, label in lines:
            write_png(folder / f"{name}.png", img[..., ::-1])
            (folder / f"{name}.txt").write_text(label + "\n",
                                                encoding="utf-8")


# ---------------------------------------------------------------------------
# Training batches, in the engines' exact input representation
# ---------------------------------------------------------------------------

def extraction_matched_strip(
    rng: np.random.RandomState, glyphs, charset=WYLIE_CHARSET,
    k_factor: float = 2.5, bbox_tolerance: float = 4.0, gap=(50, 90),
    tokens: list[str] | None = None, n_syllables=(4, 10),
    syllable_len=(1, 4), shear_deg: float = 0.0, curve_amp: float = 0.0,
) -> tuple[np.ndarray, list[str]]:
    """One recognizer training sample cut by the page pipeline's own strip
    extraction (eval/synthetic.py:340-436): the target line rendered in
    page context (neighbour lines at page pitch, the page margin), the
    context optionally curved and rotated as the eval pages are, then
    ``geometry.get_line_image`` with run_ocr's k_factor and tolerance on a
    contour grown by the distortion's displacement."""
    from ocr_inference_tpu_torch.geometry.lines import get_line_image

    if tokens is None:
        tokens = sample_tokens(rng, charset, n_syllables, syllable_len)
    strip = render_line_strip(tokens, glyphs, rng)
    pitch = _glyph_height(glyphs) + int(rng.randint(*gap))
    margin = 48  # render_page's: page-top and page-bottom lines as on pages
    sh, sw = strip.shape[:2]
    canvas_w = sw + 2 * margin
    canvas_h = 2 * margin + 3 * pitch
    canvas = rng.randint(215, 250, (canvas_h, canvas_w, 3)).astype(np.uint8)
    # target slot 0 = page top, 1 = interior, 2 = page bottom, drawn with
    # the page-line frequency of boundary rows
    target = (0, 1, 1, 1, 2)[int(rng.randint(5))]
    rows = {0: (0, 1), 1: (0, 1, 2), 2: (1, 2)}[target]
    y_t = x_t = 0
    for row in rows:
        y0 = margin + row * pitch + int(rng.randint(-3, 4))
        if row == target:
            s, x0 = strip, margin
            y_t, x_t = y0, x0
        else:
            s = render_line_strip(
                sample_tokens(rng, charset, n_syllables, syllable_len),
                glyphs, rng)
            s = s[:, : canvas_w - margin]
            x0 = int(rng.randint(0, max(canvas_w - margin - s.shape[1], 1)))
        canvas[y0: y0 + s.shape[0], x0: x0 + s.shape[1]] = s
    if target == 0:
        canvas = canvas[: 2 * margin + 2 * pitch]
    elif target == 2:
        canvas = canvas[pitch:]
        y_t -= pitch
    if shear_deg > 0 or curve_amp > 0:
        canvas = distort_page(canvas, rng, shear_deg=shear_deg,
                              curve_amp=curve_amp)
    # the contour covers the displaced ink, as a detection contour would
    grow = int(np.ceil(curve_amp + sw * np.sin(np.radians(shear_deg)) / 2))
    y0 = max(y_t - grow, 0)
    y1 = min(y_t + sh - 1 + grow, canvas.shape[0] - 1)
    contour = np.array(
        [[[x_t, y0]], [[x_t + sw - 1, y0]], [[x_t + sw - 1, y1]],
         [[x_t, y1]]], dtype=np.int32)
    img, _ = get_line_image(canvas, contour, y1 - y0 + 1,
                            bbox_tolerance=bbox_tolerance, k_factor=k_factor)
    return img, tokens


def recognizer_batch(
    rng: np.random.RandomState, glyphs, charset, batch: int,
    input_height: int = 80, width: int = 512, max_label: int = 48,
    n_syllables=(4, 10), syllable_len=(1, 4), degrade_max: float = 0.0,
    shear_max_deg: float = 0.0, curve_max_amp: float = 0.0,
    geo_prob: float = 1.0, device=None,
) -> dict:
    """A CTC training batch in the RecognitionEngine's input
    representation (eval/synthetic.py:439-530): per sample a geometric
    coin flip (``geo_prob``) and draws of shear and curve, an
    ``extraction_matched_strip`` (drawn again, as JAX draws it, while its
    labels overflow ``max_label`` or its scaled width the canvas), an
    optional degradation ~ U(0, degrade_max), the canvas of
    ``tiling.pad_ocr_line`` and its gray. The (batch, input_height, width)
    canvases are binarized on ``device`` by ``kernels.binarize_lines`` and
    scaled to {-1, +1}. Returns {"images", "image_widths", "labels",
    "label_lengths"} as tensors on ``device`` (None: cuda)."""
    dev = resolve_device(device)
    gray = np.zeros((batch, input_height, width), np.uint8)
    labels = np.zeros((batch, max_label), np.int32)
    label_lengths = np.zeros((batch,), np.int32)
    for b in range(batch):
        geo = geo_prob >= 1.0 or float(rng.uniform()) < geo_prob
        sd = (float(rng.uniform(0.0, shear_max_deg))
              if (shear_max_deg and geo) else 0.0)
        ca = (float(rng.uniform(0.0, curve_max_amp))
              if (curve_max_amp and geo) else 0.0)
        strip, tokens = extraction_matched_strip(
            rng, glyphs, charset, n_syllables=n_syllables,
            syllable_len=syllable_len, shear_deg=sd, curve_amp=ca)
        if len(tokens) > max_label:
            tokens = tokens[: max_label - 1]
            strip, _ = extraction_matched_strip(
                rng, glyphs, charset, tokens=tokens, shear_deg=sd,
                curve_amp=ca)
        scale = input_height / strip.shape[0]
        while strip.shape[1] * scale > width and len(tokens) > 2:
            tokens = tokens[: max(len(tokens) - 2, 2)]
            strip, _ = extraction_matched_strip(
                rng, glyphs, charset, tokens=tokens, shear_deg=sd,
                curve_amp=ca)
            scale = input_height / strip.shape[0]
        if degrade_max > 0:
            strip = degrade_page(strip, rng,
                                 float(rng.uniform(0.0, degrade_max)))
        canvas = pad_ocr_line(torch.from_numpy(np.ascontiguousarray(strip)),
                              width, input_height)
        gray[b] = rgb_to_gray(canvas).numpy()
        ids = [charset.index(t) + 1 for t in tokens]
        labels[b, : len(ids)] = ids
        label_lengths[b] = len(ids)
    bw = kernels.binarize_lines(torch.from_numpy(gray).to(dev))
    return {
        "images": (bw > 0).to(torch.float32) * 2.0 - 1.0,
        "image_widths": torch.full((batch,), width, dtype=torch.int32,
                                   device=dev),
        "labels": torch.from_numpy(labels).to(dev),
        "label_lengths": torch.from_numpy(label_lengths).to(dev),
    }


def segmentation_batch(rng: np.random.RandomState, glyphs, charset,
                       batch: int, patch: int = 512, device=None) -> dict:
    """A tile training batch in the SegmentationEngine's input
    representation (eval/synthetic.py:533-574): ``render_page`` pages two
    tiles wide, padded with white to whole tiles, cut into ``patch``-square
    tiles in row order until ``batch`` are taken; the (batch, patch,
    patch, 3) RGB tiles are binarized on ``device`` by
    ``kernels.binarize_tiles`` and repeated to three channels in {0, 1},
    with the page's line mask as the (batch, patch, patch, 1) target.
    Returns {"images", "targets"} as float32 NHWC tensors on ``device``
    (None: cuda)."""
    dev = resolve_device(device)
    tiles = np.zeros((batch, patch, patch, 3), np.uint8)
    targets = np.zeros((batch, patch, patch, 1), np.float32)
    b = 0
    while b < batch:
        pg = render_page(rng, glyphs, charset, page_w=patch * 2)
        padded_h = -(-pg.image.shape[0] // patch) * patch
        img = np.full((padded_h, patch * 2, 3), 255, np.uint8)
        img[: pg.image.shape[0]] = pg.image
        msk = np.zeros((padded_h, patch * 2), np.uint8)
        msk[: pg.line_mask.shape[0]] = pg.line_mask
        for ty in range(padded_h // patch):
            for tx in range(2):
                if b >= batch:
                    break
                ys, xs = slice(ty * patch, (ty + 1) * patch), \
                    slice(tx * patch, (tx + 1) * patch)
                tiles[b] = img[ys, xs]
                targets[b, ..., 0] = msk[ys, xs] > 0
                b += 1
    bw = kernels.binarize_tiles(torch.from_numpy(tiles).to(dev))
    images = (bw > 0).to(torch.float32)[..., None].expand(-1, -1, -1, 3)
    return {"images": images.contiguous(),
            "targets": torch.from_numpy(targets).to(dev)}

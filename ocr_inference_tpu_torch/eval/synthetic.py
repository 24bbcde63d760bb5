"""Synthetic pecha pages without OpenCV, for the port's checks on the card.

A copy of the numpy part of ocr_inference_tpu/eval/synthetic.py
(``sample_tokens``, ``render_line_strip``, ``render_page``, the rotation of
``distort_page``): the same ``np.random.RandomState`` calls in the same
order, so the same seed gives the same page bytes. The glyph bitmaps, which
the JAX package draws with cv2, come from the caller (the committed
fixture ``tests/data/torch_port/pages.npz`` stores them packed), and the
page rotation uses the port's own warpAffine.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ocr_inference_tpu_torch.ops.imaging import rotation_matrix, warp_affine

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


def fixture_pages(path: str | Path) -> list[tuple[str, np.ndarray, list[str]]]:
    """Rebuild the pages of ``tests/data/torch_port/pages.npz`` ->
    [(name, RGB page, ground-truth line texts)]. A rotated page is the
    port's rotation of its clean page plus the stored int8 residual to the
    cv2 rotation the fixture was made with, so the bytes are cv2's."""
    with np.load(path) as npz:
        glyphs = unpack_glyphs(npz)
        charset = [str(t) for t in npz["charset"]]
        pages = []
        for i, name in enumerate(npz["names"]):
            rng = np.random.RandomState(int(npz["seeds"][i]))
            img, texts = render_page(rng, glyphs, charset)
            deg = float(npz["rotations"][i])
            if deg != 0.0:
                residual = npz[f"residual_{i}"].astype(np.int16)
                img = (rotate_page(img, deg).astype(np.int16) + residual
                       ).astype(np.uint8)
            pages.append((str(name), img, texts))
    return pages

"""Write the page fixture the PyTorch port is checked with on the card.

Three eval/synthetic.py ``render_page`` pages with the 77-unit Wylie glyph
set (two clean, one rotated by 2 degrees as ``distort_page`` does for the
``skew_2deg`` distribution of cli/selftrain_cli.py:489, so the deskew
rotation runs), and the JAX package's ``build_pipeline(...).run_ocr`` texts
for them with the full77f weights in float32:

    tests/data/torch_port/pages.npz   glyph bitmaps, page seeds, rotations,
                                      and the int8 residual of the rotated
                                      page (the pages are rebuilt from these
                                      by ocr_inference_tpu_torch.eval.synthetic
                                      .fixture_pages, byte for byte)
    tests/data/torch_port/texts.json  ground truth + JAX float32 texts and
                                      line boxes, Wylie

Run from the repository root with JAX on the CPU (a few minutes):

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "torch_port"
WEIGHTS = REPO / "artifacts" / "full77f"
PAGES = [("clean_a", 101, 0.0), ("clean_b", 202, 0.0), ("skew_2deg", 303, 2.0)]
INPUT_WIDTH = 3000


def full77f_configs(ocr_cls, line_cls, encoder):
    """(OCRModelConfig, LineDetectionConfig) for the full77f weights; the
    charset comes from the recognizer's sidecar."""
    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    ocr = ocr_cls(
        model_file=str(WEIGHTS / "recognizer.onnx"), architecture="Easter2",
        input_width=INPUT_WIDTH, input_height=80, input_layer="input",
        output_layer="output", squeeze_channel=True, swap_hw=False,
        encoder=encoder, charset=list(meta["charset"]), add_blank=True,
        version="full77f",
    )
    line = line_cls(
        checkpoint="", onnx_file=str(WEIGHTS / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    return ocr, line


def main() -> int:
    sys.path.insert(0, str(REPO))
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, LineDetectionConfig, OCRModelConfig,
        OpStatus,
    )
    from ocr_inference_tpu.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, distort_page, render_page,
    )
    from ocr_inference_tpu.pipeline.builder import build_pipeline
    from ocr_inference_tpu_torch.eval import synthetic as port_synth

    glyph_set = GlyphSet(charset=WYLIE_CHARSET_FULL, height=40, seed=7)
    glyphs = {t: glyph_set.glyph(t) for t in WYLIE_CHARSET_FULL}
    arrays = port_synth.pack_glyphs(glyphs)
    arrays["charset"] = np.array(WYLIE_CHARSET_FULL)
    arrays["names"] = np.array([n for n, _, _ in PAGES])
    arrays["seeds"] = np.array([s for _, s, _ in PAGES], np.int64)
    rotations = []
    pages = []
    for i, (name, seed, shear) in enumerate(PAGES):
        page = render_page(np.random.RandomState(seed), glyph_set,
                           WYLIE_CHARSET_FULL)
        img = page.image
        deg = 0.0
        if shear:
            dist_rng = np.random.RandomState(seed + 1000)
            # distort_page draws the sign from its rng first
            deg = shear * (1 if int(np.random.RandomState(seed + 1000)
                                    .randint(2)) else -1)
            img = distort_page(img, dist_rng, shear_deg=shear)
            rebuilt = port_synth.rotate_page(page.image, deg)
            residual = img.astype(np.int16) - rebuilt.astype(np.int16)
            arrays[f"residual_{i}"] = residual.astype(np.int8)
        rotations.append(deg)
        pages.append((name, img, page.texts))
    arrays["rotations"] = np.array(rotations, np.float64)
    OUT.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT / "pages.npz", **arrays)

    # the committed fixture must rebuild the exact pages
    for (name, img, texts), (name2, img2, texts2) in zip(
        pages, port_synth.fixture_pages(OUT / "pages.npz")
    ):
        assert name == name2 and texts == texts2, name
        assert np.array_equal(img, img2), name

    ocr_cfg, line_cfg = full77f_configs(OCRModelConfig, LineDetectionConfig,
                                        CharsetEncoder.WYLIE)
    pipe = build_pipeline(ocr_cfg, line_cfg, dtype=jnp.float32)
    record = {"weights": "artifacts/full77f", "dtype": "float32",
              "input_width": INPUT_WIDTH, "pages": []}
    for name, img, texts in pages:
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE)
        if status != OpStatus.SUCCESS:
            raise RuntimeError(f"{name}: JAX pipeline failed: {payload}")
        _, lines, ocr_lines, angle = payload
        record["pages"].append({
            "name": name,
            "shape": list(img.shape),
            "ground_truth": texts,
            "jax_f32_texts": [ln.text for ln in ocr_lines],
            "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in lines],
            "jax_angle": angle,
        })
        print(name, img.shape, f"angle {angle:.3f}",
              len(ocr_lines), "lines", file=sys.stderr)
    (OUT / "texts.json").write_text(
        json.dumps(record, indent=1, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

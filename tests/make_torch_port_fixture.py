"""Write the page fixture the PyTorch port is checked with on the card.

Three eval/synthetic.py ``render_page`` pages with the 77-unit Wylie glyph
set (two clean, one rotated by 2 degrees as ``distort_page`` does for the
``skew_2deg`` distribution of cli/selftrain_cli.py:489, so the deskew
rotation runs), and the JAX package's ``build_pipeline(...).run_ocr`` texts
for them with the full77f weights in float32:

    tests/data/torch_port/pages.npz   glyph bitmaps, page seeds and
                                      rotations (the pages are rebuilt from
                                      these by ocr_inference_tpu_torch.eval
                                      .synthetic.fixture_pages, byte for byte:
                                      the port's rotation equals cv2's)
    tests/data/torch_port/texts.json  ground truth + JAX float32 texts and
                                      line boxes, Wylie

Run from the repository root with JAX on the CPU (a few minutes):

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py

With the argument ``eval_suite`` it writes instead the JAX float32 record
the port's dewarp and eval suite are held against (about five minutes):

    tests/data/torch_port/eval_suite.json
        ``pages``: the 150 seed-5 pages of the six-distribution eval
        (cli/selftrain_cli.py:470-552, greedy decode, canvas width 512 as
        that CLI defaults): each page's distribution, the sha256 of its
        bytes and of its ground truth, and the JAX texts, line count and
        TPS gate;
        ``lm``: eval mode as the CLI runs it with its default LM
        (cli/selftrain_cli.py:386-466, :527-540, :632-645): the order-3
        token ARPA built from the CLI's corpus (it must equal
        artifacts/full77f/lm.arpa byte for byte), the ``calibrate_lm``
        report on 16 pipeline-extracted strips of the ``RandomState(5 +
        31337)`` calibration pages, the pooled ``cer_beam`` and
        ``cer_beam_lm``, and the fusion state after calibration; each page
        also holds its top-1 plain and fused beam texts
        (``jax_f32_beam_text``, ``jax_f32_beam_lm_text``);
        ``curved``: two bench.py config 2 pages (``make_curved_volume``)
        through ``run_ocr(use_tps=True)``: the TPS ratio, whether the warp
        ran, its band ``b`` and ``max_dy``, the line counts before and
        after the warp, and the line boxes and texts.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py eval_suite

With the argument ``eval_mode`` it writes the JAX float32 eval-mode
record of the three fixture pages (about a minute):

    tests/data/torch_port/eval_mode.json
        per page, ``run_ocr(eval_mode=True)`` with the eval LM
        (artifacts/full77f/lm.arpa, alpha 0.5, beta 0): the top-1 beam
        texts, line boxes, ``ctc_conf`` and the top beams' scores; and the
        top-1 texts of the page's strips through ``run_batch_beams`` with
        the LM fused (``use_lm=True``), before any calibration.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py eval_mode

With the argument ``layout`` it writes the JAX float32 layout-mode record
(a few minutes):

    tests/data/torch_port/layout.json
        The repository has no layout checkpoint, so the full-width
        DeepLabV3+ (five classes, builder.py:241) runs with the port's
        seeded weights (``pipeline.builder.seeded_variables``, numpy only),
        loaded into the JAX module. The seed is the first from 0 up with
        which, on every record page, at least two classes are non-empty
        and ``run_ocr`` in layout mode returns SUCCESS with at least one
        line; the seeds skipped before it are recorded with the reason.
        Per page (the three fixture pages and bench.py config 4's first
        page): each class's pixel count and the sha256 of its packed mask
        (``packed_mask_sha256``), and ``run_ocr``'s status, line boxes
        and texts with the full77f recognizer; and
        ``ModernBookFormatLayoutDetection.run``'s JSON for the three
        fixture pages, written as PNG.
    tests/data/torch_port/layout_masks.npz
        the same masks, one (C, H, ceil(W / 8)) array of bits packed along
        each row (``np.packbits``) per page name, so that a run can count
        the pixels that differ (about 160 kB).

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py layout

The JAX warp is pinned to its device path (``OCR_TPS_HOST=0``): the port
has no host warp.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "torch_port"
WEIGHTS = REPO / "artifacts" / "full77f"
PAGES = [("clean_a", 101, 0.0), ("clean_b", 202, 0.0), ("skew_2deg", 303, 2.0)]
INPUT_WIDTH = 3000
# the eval suite of cli/selftrain_cli.py:484-491:
# (name, degrade level, shear degrees, curve amplitude px, use_tps)
EVAL_SUITE = (
    ("clean", 0.0, 0.0, 0.0, False),
    ("degrade_03", 0.3, 0.0, 0.0, False),
    ("degrade_06", 0.6, 0.0, 0.0, False),
    ("shear_05", 0.0, 0.5, 0.0, False),
    ("skew_2deg", 0.0, 2.0, 0.0, False),
    ("curve_tps", 0.0, 0.0, 10.0, True),
)
EVAL_SEED, EVAL_PAGES, EVAL_CANVAS = 5, 150, 512
# the eval CLI's LM defaults (selftrain_cli.py --lm-order, --lm-corpus-lines,
# --lm-calib-lines, --lm-alpha, --lm-beta)
LM_ORDER, LM_CORPUS_LINES, LM_CALIB_LINES = 3, 500, 16
LM_ALPHA, LM_BETA = 0.5, 0.0
LM_ARPA = WEIGHTS / "lm.arpa"
CURVED_PAGES = 2
# the reference CLI's layout classes (builder.py:241)
LAYOUT_CLASSES = ["background", "image", "line", "caption", "margin"]


def sha256(data) -> str:
    """Hex sha256 of an array's bytes or of a UTF-8 string."""
    raw = data.encode() if isinstance(data, str) else \
        np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(raw).hexdigest()


def packed_mask_sha256(mask) -> str:
    """sha256 of one class's (H, W) mask packed to bits along each row."""
    return sha256(np.packbits(np.asarray(mask) > 0, axis=-1))


def full77f_configs(ocr_cls, line_cls, encoder, input_width=INPUT_WIDTH):
    """(OCRModelConfig, LineDetectionConfig) for the full77f weights; the
    charset comes from the recognizer's sidecar."""
    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    ocr = ocr_cls(
        model_file=str(WEIGHTS / "recognizer.onnx"), architecture="Easter2",
        input_width=input_width, input_height=80, input_layer="input",
        output_layer="output", squeeze_channel=True, swap_hw=False,
        encoder=encoder, charset=list(meta["charset"]), add_blank=True,
        version="full77f",
    )
    line = line_cls(
        checkpoint="", onnx_file=str(WEIGHTS / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    return ocr, line


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(REPO))
    if argv == ["eval_suite"]:
        return eval_suite()
    if argv == ["eval_mode"]:
        return eval_mode()
    if argv == ["layout"]:
        return layout()
    if argv:
        raise SystemExit(f"unknown arguments {argv}; expected eval_suite, "
                         "eval_mode or layout")
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


def eval_mode() -> int:
    """Write tests/data/torch_port/eval_mode.json (see the module doc)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, KenLMConfig, LineDetectionConfig,
        OCRModelConfig, OpStatus,
    )
    from ocr_inference_tpu.pipeline.builder import build_pipeline
    from ocr_inference_tpu.pipeline.ocr_pipeline import PipelineObserver
    from ocr_inference_tpu_torch.eval import synthetic as port_synth

    class Capture(PipelineObserver):
        strips = None

        def stage_end(self, stage, payload):
            if stage == "extract_lines":
                self.strips = payload[1]

    pipe = build_pipeline(
        *full77f_configs(OCRModelConfig, LineDetectionConfig,
                         CharsetEncoder.WYLIE),
        kenlm_config=KenLMConfig(str(LM_ARPA), str(LM_ARPA), None,
                                 alpha=LM_ALPHA, beta=LM_BETA),
        dtype=jnp.float32)
    record = {"weights": "artifacts/full77f", "dtype": "float32",
              "input_width": INPUT_WIDTH,
              "lm": str(LM_ARPA.relative_to(REPO)), "lm_alpha": LM_ALPHA,
              "lm_beta": LM_BETA, "pages": []}
    for name, img, _ in port_synth.fixture_pages(OUT / "pages.npz"):
        cap = Capture()
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE,
                                       eval_mode=True, observer=cap)
        if status != OpStatus.SUCCESS:
            raise RuntimeError(f"{name}: JAX pipeline failed: {payload}")
        _, lines, ocr_lines, angle = payload
        fused = pipe.ocr_inference.run_batch_beams(cap.strips, use_lm=True,
                                                   top_k=1)
        record["pages"].append({
            "name": name,
            "jax_f32_beam_texts": [ln.text for ln in ocr_lines],
            "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in lines],
            "jax_f32_ctc_conf": [ln.ctc_conf for ln in ocr_lines],
            "jax_f32_beam_scores": [ln.logits for ln in ocr_lines],
            "jax_f32_fused_texts": [
                b[0].text.strip().replace("§", " ") if b else ""
                for b in fused],
            "jax_angle": angle,
        })
        print(name, len(ocr_lines), "lines", file=sys.stderr)
    (OUT / "eval_mode.json").write_text(
        json.dumps(record, indent=1, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )
    return 0


def layout() -> int:
    """Write tests/data/torch_port/layout.json (see the module doc)."""
    import tempfile

    import cv2
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

    import bench
    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, LayoutDetectionConfig, LineDetectionConfig,
        OCRModelConfig, OpStatus,
    )
    from ocr_inference_tpu.models import DeepLabV3Plus
    from ocr_inference_tpu.pipeline.builder import build_recognition_engine
    from ocr_inference_tpu.pipeline.engines import SegmentationEngine
    from ocr_inference_tpu.pipeline.modern_layout import (
        ModernBookFormatLayoutDetection,
    )
    from ocr_inference_tpu.pipeline.ocr_pipeline import OCRPipeline
    from ocr_inference_tpu_torch.eval import synthetic as port_synth
    from ocr_inference_tpu_torch.models.segmentation import (
        DeepLabV3Plus as PortDeepLab,
    )
    from ocr_inference_tpu_torch.pipeline.builder import seeded_variables

    ocr_cfg, _ = full77f_configs(OCRModelConfig, LineDetectionConfig,
                                 CharsetEncoder.WYLIE)
    rec = build_recognition_engine(ocr_cfg, dtype=jnp.float32)
    cfg = LayoutDetectionConfig(checkpoint="", onnx_file="",
                                architecture="deeplabv3", patch_size=512,
                                classes=LAYOUT_CLASSES)
    fixture = [(name, img) for name, img, _ in
               port_synth.fixture_pages(OUT / "pages.npz")]
    pages = fixture + [("bench_cfg4_0", bench.make_volume(1)[0])]
    model = DeepLabV3Plus(classes=len(LAYOUT_CLASSES), dtype=jnp.float32)

    def read(det, seed):
        """Per page: masks and run_ocr; the reason when the seed fails."""
        pipe = OCRPipeline(rec, det, cfg)
        out = []
        masks.clear()
        for name, img in pages:
            mask = det.predict(img)
            counts = [int((mask[:, :, c] > 0).sum())
                      for c in range(len(LAYOUT_CLASSES))]
            if sum(n > 0 for n in counts) < 2:
                return out, (f"{name}: fewer than two classes non-empty "
                             f"{counts}")
            status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE)
            if status != OpStatus.SUCCESS:
                return out, f"{name}: run_ocr {status.name}: {payload}"
            if not payload[2]:
                return out, f"{name}: run_ocr read no lines"
            _, lines, ocr_lines, angle = payload
            masks[name] = np.packbits(mask.transpose(2, 0, 1) > 0, axis=-1)
            out.append({
                "name": name, "shape": list(img.shape), "sha256": sha256(img),
                "classes": {
                    cls: {"pixels": counts[c],
                          "packed_mask_sha256": packed_mask_sha256(
                              mask[:, :, c])}
                    for c, cls in enumerate(LAYOUT_CLASSES)},
                "status": status.name,
                "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in lines],
                "jax_f32_texts": [ln.text for ln in ocr_lines],
                "jax_angle": angle,
            })
            print(seed, name, counts, len(ocr_lines), "lines",
                  file=sys.stderr)
        return out, None

    skipped, masks = [], {}
    for seed in range(64):
        variables = seeded_variables(PortDeepLab(len(LAYOUT_CLASSES)), seed)
        det = SegmentationEngine(model, variables, mode="layout",
                                 classes=LAYOUT_CLASSES)
        records, reason = read(det, seed)
        if reason is None:
            break
        print("seed", seed, "skipped:", reason, file=sys.stderr)
        skipped.append({"seed": seed, "reason": reason})
    else:
        raise RuntimeError("no seed in 0..63 exercises layout mode")

    with tempfile.TemporaryDirectory() as tmp:
        page_dir, out_dir = Path(tmp) / "pages", Path(tmp) / "json"
        page_dir.mkdir()
        for name, img in fixture:
            cv2.imwrite(str(page_dir / f"{name}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        modern = ModernBookFormatLayoutDetection(cfg, engine=det).run(
            str(page_dir), str(out_dir))
        modern = {Path(p).stem: found for p, found in sorted(modern.items())}

    record = {
        "weights": "seeded DeepLabV3Plus(classes=5) + artifacts/full77f",
        "dtype": "float32", "backend": "cpu", "input_width": INPUT_WIDTH,
        "classes": LAYOUT_CLASSES, "seed": seed, "skipped_seeds": skipped,
        "class_threshold": 0.8, "pages": records, "modern_layout": modern,
    }
    (OUT / "layout.json").write_text(
        json.dumps(record, indent=1, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )
    np.savez_compressed(OUT / "layout_masks.npz", **masks)
    return 0


def eval_suite() -> int:
    """Write tests/data/torch_port/eval_suite.json (see the module doc)."""
    os.environ["OCR_TPS_HOST"] = "0"
    import cv2
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

    import bench
    import tempfile

    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, KenLMConfig, LineDetectionConfig,
        OCRModelConfig, OpStatus,
    )
    from ocr_inference_tpu.decode.ngram_builder import build_char_arpa
    from ocr_inference_tpu.dewarp import tps as T
    from ocr_inference_tpu.eval.cer import cer
    from ocr_inference_tpu.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, degrade_page, distort_page,
        render_page, sample_tokens,
    )
    from ocr_inference_tpu.ops.packing import pack_bits_host
    from ocr_inference_tpu.pipeline.builder import build_pipeline
    from ocr_inference_tpu.pipeline.ocr_pipeline import PipelineObserver

    class Dewarp(PipelineObserver):
        def __init__(self):
            self.result = None
            self.strips = []

        def stage_end(self, stage, payload):
            if stage == "dewarping":
                self.result = payload
            elif stage == "extract_lines":
                self.strips = payload[1]

    def pipeline(width, kenlm_config=None):
        return build_pipeline(
            *full77f_configs(OCRModelConfig, LineDetectionConfig,
                             CharsetEncoder.WYLIE, input_width=width),
            kenlm_config=kenlm_config, dtype=jnp.float32)

    def beam_text(beams) -> str:
        return beams[0].text.strip().replace("§", " ") if beams else ""

    # the CLI's LM: built from its corpus, it is the committed lm.arpa
    lm_rng = np.random.RandomState(EVAL_SEED + 77)
    corpus = [" ".join(sample_tokens(lm_rng, WYLIE_CHARSET_FULL))
              for _ in range(LM_CORPUS_LINES)]
    with tempfile.TemporaryDirectory() as tmp:
        built = build_char_arpa(corpus, Path(tmp) / "lm.arpa",
                                order=LM_ORDER, tokens=True).read_bytes()
    if built != LM_ARPA.read_bytes():
        raise RuntimeError(f"the CLI's LM differs from {LM_ARPA}")
    kenlm_cfg = KenLMConfig(kenlm_file=str(LM_ARPA), arpa_file=str(LM_ARPA),
                            unigrams=None, alpha=LM_ALPHA, beta=LM_BETA)

    record = {
        "weights": "artifacts/full77f", "dtype": "float32", "backend": "cpu",
        "seed": EVAL_SEED, "canvas_width": EVAL_CANVAS,
        "suite": [list(row) for row in EVAL_SUITE], "pages": [],
    }
    pipe = pipeline(EVAL_CANVAS, kenlm_cfg)
    rec_engine = pipe.ocr_inference
    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, height=40, seed=7)

    # calibration (selftrain_cli.py:439-466): pipeline-extracted strips of
    # pages whose line count equals the rendered count
    calib_rng = np.random.RandomState(EVAL_SEED + 31_337)
    strips, calib_refs, calib_pages, attempts = [], [], [], 0
    while len(strips) < LM_CALIB_LINES and attempts < 50:
        attempts += 1
        page = render_page(calib_rng, glyphs, WYLIE_CHARSET_FULL)
        img = degrade_page(page.image, calib_rng, 0.0)
        obs = Dewarp()
        status, _ = pipe.run_ocr(img, target_encoding=Encoding.WYLIE,
                                 observer=obs)
        if status != OpStatus.SUCCESS or len(obs.strips) != len(page.texts):
            continue
        strips.extend(obs.strips)
        calib_refs.extend(page.texts)
        calib_pages.append(attempts - 1)
    report = rec_engine.calibrate_lm(strips[:LM_CALIB_LINES],
                                     calib_refs[:LM_CALIB_LINES])
    print("calibration", report, file=sys.stderr)

    rng = np.random.RandomState(EVAL_SEED + 10_000)
    gts = []
    for p in range(EVAL_PAGES):
        page = render_page(rng, glyphs, WYLIE_CHARSET_FULL)
        name, level, shear, curve, use_tps = EVAL_SUITE[p % len(EVAL_SUITE)]
        img = page.image
        if shear or curve:
            img = distort_page(img, rng, shear_deg=shear, curve_amp=curve)
        img = degrade_page(img, rng, level)
        obs = Dewarp()
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE,
                                       observer=obs, use_tps=use_tps)
        ok = status == OpStatus.SUCCESS
        text = " ".join(ln.text for ln in payload[2]) if ok else ""
        beam = beam_lm = ""
        if ok and obs.strips:
            beam = " ".join(beam_text(b) for b in rec_engine.run_batch_beams(
                obs.strips, use_lm=False, top_k=1))
            beam_lm = " ".join(beam_text(b) for b in
                               rec_engine.run_batch_beams(
                                   obs.strips, use_lm=True, top_k=1))
        gt = " ".join(page.texts)
        gts.append(gt)
        dw = obs.result
        record["pages"].append({
            "dist": name, "shape": list(img.shape), "sha256": sha256(img),
            "gt_sha256": sha256(gt), "status": status.name,
            "lines": len(payload[2]) if ok else 0, "jax_f32_text": text,
            "jax_f32_cer": cer([text], [gt]),
            "tps_ratio": None if dw is None else dw.tps_ratio,
            "tps_applied": bool(dw is not None and dw.applied),
            "jax_f32_beam_text": beam, "jax_f32_beam_lm_text": beam_lm,
        })
        print(p, name, record["pages"][-1]["jax_f32_cer"],
              cer([beam], [gt]), cer([beam_lm], [gt]), file=sys.stderr)

    pages = record["pages"]
    record["lm"] = {
        "arpa": str(LM_ARPA.relative_to(REPO)), "order": LM_ORDER,
        "corpus_lines": LM_CORPUS_LINES, "calib_lines": LM_CALIB_LINES,
        "calib_pages": calib_pages, "calib_attempts": attempts,
        "calib_refs": calib_refs[:LM_CALIB_LINES],
        "cer_beam": cer([p["jax_f32_beam_text"] for p in pages], gts),
        "cer_beam_lm": cer([p["jax_f32_beam_lm_text"] for p in pages], gts),
        "lm_alpha": rec_engine.ctc_decoder_lm.lm_alpha,
        "lm_beta": rec_engine.ctc_decoder_lm.lm_beta,
        "lm_fusion_enabled": rec_engine.lm_fusion_enabled,
        "lm_calibration": report,
    }
    print("lm", {k: v for k, v in record["lm"].items() if k != "calib_refs"},
          file=sys.stderr)

    curved = []
    pipe = pipeline(INPUT_WIDTH)
    for img in bench.make_curved_volume(CURVED_PAGES):
        _, built = pipe.build_lines(img, pipe.detect_lines(img)[1])
        rot_img, rot_mask, _, filtered, _ = built
        _, line_data = T.check_for_tps(rot_img, filtered)
        best = line_data[T.get_global_tps_line(line_data)]
        h, w = rot_img.shape[:2]
        corners = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]],
                           np.float64) * [h, w]
        src = np.concatenate([np.asarray(best["output_pts"], np.float64),
                              corners])
        dst = np.concatenate([np.asarray(best["input_pts"], np.float64),
                              corners])
        control, weights, affine = T.fit_tps(src, dst)
        dy_bound = float(np.max(np.abs(src[:, 0] - dst[:, 0])))
        b = max(32, -int(-(1.5 * dy_bound + 16) // 32) * 32)
        gray = cv2.cvtColor(rot_img, cv2.COLOR_RGB2GRAY)
        _, _, max_dy = T._warp_pair_vertical(
            jnp.asarray(gray), jnp.asarray(pack_bits_host(rot_mask > 0)),
            jnp.asarray(control, jnp.float32),
            jnp.asarray(weights, jnp.float32),
            jnp.asarray(affine, jnp.float32), b=b)
        obs = Dewarp()
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE,
                                       observer=obs, use_tps=True)
        if status != OpStatus.SUCCESS:
            raise RuntimeError(f"curved page: JAX pipeline failed: {payload}")
        _, lines, ocr_lines, angle = payload
        curved.append({
            "shape": list(img.shape), "sha256": sha256(img),
            "tps_ratio": obs.result.tps_ratio,
            "applied": bool(obs.result.applied), "b": b,
            "max_dy": float(max_dy),
            "lines_before": len(filtered),
            "lines_after": len(obs.result.filtered_contours),
            "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in lines],
            "jax_f32_texts": [ln.text for ln in ocr_lines],
            "angle": angle,
        })
        print("curved", curved[-1]["tps_ratio"], b, float(max_dy),
              file=sys.stderr)
    record["curved"] = {"input_width": INPUT_WIDTH, "pages": curved}
    (OUT / "eval_suite.json").write_text(
        json.dumps(record, indent=0, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

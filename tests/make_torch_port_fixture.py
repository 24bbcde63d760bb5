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

With the argument ``recognizers`` it writes the JAX float32 record of the
other recognizers and of the eval CLI (a few minutes):

    tests/data/torch_port/recognizers.json
        The repository has no weights for Easter2-Attention, Easter2-Vit
        or CRNN, so each runs at full width with the port's seeded weights
        (``pipeline.builder.seeded_variables``, seed 0, the head gain
        included), loaded into the Flax module. Per architecture and
        fixture page, ``run_ocr``'s status, line boxes and texts behind the
        full77f line detector; the eval CLI's line dataset (the seed and
        size of ``eval.synthetic.line_dataset``) with the JAX ``bocr-eval``
        per-line CERs, mean CERs and score files for full77f in float32.
    tests/data/torch_port/recognizer_logits.npz
        ``canvases``: four binarized (80, 512) canvases of the first
        fixture page's lines (the port's prepare_canvas at the eval
        canvas width, the line kernel's plain version); per architecture
        the Flax module's float32 logits on them at the Flax
        initialisers' scale (divided by the head gain, a power of two).

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py recognizers

With the argument ``images`` it writes the encoded page files the port's
image readers are held to on the card (the card machine has neither cv2
nor PIL, so the files are committed), and the JAX record of them (a few
minutes):

    tests/data/torch_port/images/pages/
        the fixture pages as cv2 and PIL write them: clean_a.jpg (q90,
        4:2:0, baseline), clean_b.jpg (q90, 4:4:4, progressive),
        skew_2deg.jpg (gray, q90, restart interval 4), clean_b_exif6.jpg
        (stored turned a quarter left, EXIF orientation 6), clean_a_lzw.tif
        (LZW, predictor 2, RGB), skew_2deg_g4.tif (Group 4 of the page
        thresholded at 128), clean_b_tiled16.tif (256x256 tiles, Deflate,
        predictor 2, 16-bit gray), clean_a_adam7.png (Adam7, RGB, written
        by tests/image_writers.py), and one file of each variant of
        ``variant_files``: clean_a_cmyk.jpg (CMYK JPEG, PIL),
        clean_b_cut.jpg (progressive JPEG cut inside its last scan),
        skew_2deg_jpeg420.tif (YCbCr 4:2:0 JPEG-in-TIFF in strips, tables
        in JPEGTables), clean_a_jpeg_tiles.tif (gray JPEG-in-TIFF in
        tiles), clean_b_cmyk.tif (CMYK TIFF, LZW, PIL),
        skew_2deg_ycc22.tif (YCbCr 2x2 TIFF, Deflate), clean_a_planar.tif
        (planar RGB, LZW, predictor 2) and clean_b_big.tif (big-endian
        BigTIFF, Deflate). All but clean_a.jpg hold the page with its
        paper and ink flattened to 235 and 40 (``flat_page``): the paper
        noise of the synthetic pages would make the lossless files
        megabytes. Then ``jpeg2000_bmp_pnm_files``: clean_a_97.jp2 (9/7,
        layers, RPCL, tiles, precincts), clean_b_53.j2k (raw codestream,
        5/3 lossless), skew_2deg_gray.jp2, clean_b_sycc.jp2 (sYCC 4:4:4),
        skew_2deg_sop.jp2 (SOP/EPH, PLT/TLM, tile-parts),
        clean_a_styles.jp2 (BYPASS|RESET|TERMALL code-blocks; the last
        three through OpenJPEG's own encoder), clean_a_rle8.bmp, and the
        top 128-144 rows of a page (a whole page would take megabytes)
        as clean_b_24.bmp (24-bit), clean_a_top.pgm,
        skew_2deg_16bit.ppm (16-bit) and clean_b_top.pam. All the image
        files stay under 4.2 MB together;
    tests/data/torch_port/images/none/
        files cv2 gives None for: a 12-bit JPEG, a NeXT TIFF, a sYCC 4:2:0
        JP2, a JP2 cut short, a BMP of 4-4-4 masks, a PGM cut short and a
        PAM whose tuple type does not match its depth;
    tests/data/torch_port/images/bench_cfg4.jpg, bench_cfg4.jp2
        bench.py config 4's first page (chip_smoke.bench_page, 1600x2640,
        seed 42) as a baseline 4:2:0 JPEG at the highest quality that
        keeps it under 400 KB (``BENCH_JPEG_QUALITY``), and as a 9/7 JP2
        at rate 60 (RPCL);
    tests/data/torch_port/images.json
        per file its size, sha256 and cv2's decode (``cvtColor(imread,
        BGR2RGB)``: shape and sha256); per page file the JAX float32 CPU
        ``bocr`` record: the texts of the JAX CLI (``--encoding wylie``,
        full77f, float32; ``--folder`` for the extensions it globs,
        ``--image`` for each other page file) and the line boxes of
        ``run_ocr`` with the CLI's options on cv2's decode; and the rows
        of the JAX ``bocr-lines``
        (float32, artifacts/full77f/lines.msgpack, threshold 0.85) over the
        pages folder, and over a folder of the page files of other
        extensions under ``chip_smoke.renamed_page`` names (it globs the
        same five),
        as pyarrow reads its Parquet files.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py images

``images`` also writes the HTJ2K files of ``htj2k_files``
(pages/clean_a_ht53.jph, pages/skew_2deg_ht97.j2k) and ``bench_htj2k``
(bench_cfg4_ht.j2k) with tests/htj2k_writer.py. With ``--only`` and
paths under tests/data/torch_port/images/, it writes all the files into a
temporary folder but keeps only those, and rewrites only their
images.json entries (cv2's decode, the JAX bocr and bocr-lines records),
the rest as it is; a new format's files are added so:

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py images \
        --only pages/clean_a_ht53.jph pages/skew_2deg_ht97.j2k \
        bench_cfg4_ht.j2k

With the argument ``training`` it writes the JAX CPU record of two
short training runs at full width, in float32 and in float64, which
chip_smoke.py's ``train_rec_f32`` and ``train_seg_f32`` phases repeat on
the card (about 45 minutes on 8 cores, most of it the float64 runs; it
stores no weights):

    tests/data/torch_port/training.json
        ``rec``: Easter2 from artifacts/full77f/recognizer.msgpack, five
        steps of ``make_train_step`` with ``make_optimizer(3e-4,
        total_steps=3000, warmup_steps=100)``, each on a
        ``recognizer_batch`` of full77f's recipe (the 77-unit charset,
        ``GlyphSet(height=40, seed=7)``, 32 canvases of 80x512, degrade
        0.7, shear 0.6, curve 12, geo_prob 0.35) drawn in turn from one
        ``RandomState(REC_SEED)``;
        ``seg``: the UNet (width 32, stem 2) from
        artifacts/full77f/lines.msgpack, three steps of
        ``make_seg_train_step`` with ``make_optimizer(3e-4,
        total_steps=400, warmup_steps=50)`` (selftrain's), each on a
        ``segmentation_batch`` of 8 tiles of 512^2 from one
        ``RandomState(SEG_SEED)``.
        Per step: the sha256 of each batch array, the loss, and per
        parameter leaf the norms of its gradient and of its change over
        the step (7 significant digits); then the same loss and norms of
        a float64 run on the same batches from the same weights
        (``jax.enable_x64``, the Flax modules at dtype float64; their
        heads stay float32, as the JAX package builds them), the
        reference the card's float32 steps are held to.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py training

With the argument ``onnx`` it writes the JAX float32 record the port's
``.onnx`` pipeline is held against (see ``onnx``; a few minutes):

    tests/data/torch_port/onnx.json
        the three fixture pages' texts, boxes and angle with full77f's
        weights and an ONNX detector's settings: no horizontal opening.

    JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py onnx

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
# the recognizers without weights in the repository, run with seeded ones
SEEDED_RECOGNIZERS = ("Easter2-Attention", "Easter2-Vit", "CRNN")
RECOGNIZER_SEED, LOGIT_CANVASES = 0, 4
LINE_DATASET_SEED, LINE_DATASET_PER_DIST = 11, 24


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
    if argv == ["recognizers"]:
        return recognizers()
    if argv[:1] == ["images"] and argv[1:2] in ([], ["--only"]):
        return images(argv[2:])
    if argv == ["training"]:
        return training()
    if argv == ["onnx"]:
        return onnx()
    if argv:
        raise SystemExit(f"unknown arguments {argv}; expected eval_suite, "
                         "eval_mode, layout, recognizers, images "
                         "[--only FILE...], training or onnx")
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


def onnx() -> int:
    """tests/data/torch_port/onnx.json: the JAX float32 texts and boxes of
    the three fixture pages as JAX's builder sets up an ``.onnx``
    detector: full77f's weights, but without the 2% horizontal opening
    that the builder gives a stem-2 msgpack UNet (builder.py:145-150 pass
    no ``open_width_frac`` to the ONNX SegmentationEngine). texts.json is
    the msgpack path's record; on clean_b the two differ by one thin
    tile-edge line that the opening removes. (The JAX builder cannot run
    the TorchScript export itself: its jit cannot trace the export's shape
    chains, ROADMAP §3.) A few minutes:

        JAX_PLATFORMS=cpu python tests/make_torch_port_fixture.py onnx
    """
    import jax.numpy as jnp

    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, LineDetectionConfig, OCRModelConfig,
        OpStatus,
    )
    from ocr_inference_tpu.pipeline.builder import build_pipeline
    from ocr_inference_tpu_torch.eval.synthetic import fixture_pages

    ocr_cfg, line_cfg = full77f_configs(OCRModelConfig, LineDetectionConfig,
                                        CharsetEncoder.WYLIE)
    pipe = build_pipeline(ocr_cfg, line_cfg, dtype=jnp.float32)
    pipe.line_inference.open_width_frac = 0.0
    record = {"weights": "artifacts/full77f", "dtype": "float32",
              "input_width": INPUT_WIDTH, "open_width_frac": 0.0,
              "pages": []}
    for name, img, _ in fixture_pages(OUT / "pages.npz"):
        status, payload = pipe.run_ocr(img, target_encoding=Encoding.WYLIE)
        if status != OpStatus.SUCCESS:
            raise RuntimeError(f"{name}: JAX pipeline failed: {payload}")
        _, lines, ocr_lines, angle = payload
        record["pages"].append({
            "name": name,
            "jax_f32_texts": [ln.text for ln in ocr_lines],
            "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in lines],
            "jax_angle": angle,
        })
        print(name, len(ocr_lines), "lines", file=sys.stderr)
    (OUT / "onnx.json").write_text(
        json.dumps(record, indent=1, ensure_ascii=False) + "\n",
        encoding="utf-8")
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


def seeded_recognizer_config(ocr_cls, line_cls, encoder, arch: str):
    """full77f's recognizer config with another architecture and no
    weights file, so that a builder given ``allow_random`` seeds it."""
    ocr, _ = full77f_configs(ocr_cls, line_cls, encoder)
    ocr.architecture, ocr.model_file = arch, ""
    return ocr


def recognizers() -> int:
    """Write tests/data/torch_port/recognizers.json and
    recognizer_logits.npz (see the module doc)."""
    import functools
    import tempfile

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])

    import torch

    import ocr_inference_tpu.eval.evaluator as jax_evaluator
    from ocr_inference_tpu.cli import evaluate_cli
    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, LineDetectionConfig, OCRModelConfig,
        OpStatus,
    )
    from ocr_inference_tpu.models import build_recognizer as flax_recognizer
    from ocr_inference_tpu.pipeline.builder import build_detection_engine
    from ocr_inference_tpu.pipeline.engines import RecognitionEngine
    from ocr_inference_tpu.pipeline.ocr_pipeline import OCRPipeline
    from ocr_inference_tpu_torch.core import data as port_data
    from ocr_inference_tpu_torch.eval import synthetic as port_synth
    from ocr_inference_tpu_torch.models.recognition import build_recognizer
    from ocr_inference_tpu_torch.ops.kernels import binarize_lines_plain
    from ocr_inference_tpu_torch.pipeline import PipelineObserver
    from ocr_inference_tpu_torch.pipeline.builder import (
        SEEDED_HEAD_GAIN, build_pipeline, seeded_variables,
    )

    class Strips(PipelineObserver):
        strips = None

        def stage_end(self, stage, payload):
            if stage == "extract_lines":
                self.strips = payload[1]

    pages = port_synth.fixture_pages(OUT / "pages.npz")
    # the canvases: the first page's strips on the port's CPU path at the
    # eval canvas width, binarized by the line kernel's plain version
    port = build_pipeline(
        *full77f_configs(port_data.OCRModelConfig,
                         port_data.LineDetectionConfig,
                         port_data.CharsetEncoder.WYLIE,
                         input_width=EVAL_CANVAS),
        dtype=torch.float32, device="cpu")
    obs = Strips()
    port.run_ocr(pages[0][1], observer=obs)
    canvases = np.stack([port.ocr_inference.prepare_canvas(s)
                         for s in obs.strips[:LOGIT_CANVASES]])
    bw = binarize_lines_plain(torch.from_numpy(canvases)).numpy()
    x = bw.astype(np.float32) / 127.5 - 1.0
    arrays = {"canvases": bw}

    _, line_cfg = full77f_configs(OCRModelConfig, LineDetectionConfig,
                                  CharsetEncoder.WYLIE)
    det = build_detection_engine(line_cfg, dtype=jnp.float32)
    record = {"weights": "seeded (port seeded_variables) + artifacts/full77f "
                         "lines", "dtype": "float32", "backend": "cpu",
              "seed": RECOGNIZER_SEED, "head_gain": SEEDED_HEAD_GAIN,
              "input_width": INPUT_WIDTH, "logit_canvases": list(bw.shape),
              "architectures": {}}
    for arch in SEEDED_RECOGNIZERS:
        cfg = seeded_recognizer_config(OCRModelConfig, LineDetectionConfig,
                                       CharsetEncoder.WYLIE, arch)
        vocab = len(cfg.charset) + 1
        variables = seeded_variables(build_recognizer(arch, vocab),
                                     RECOGNIZER_SEED)
        model = flax_recognizer(arch, vocab, dtype=jnp.float32)
        logits = np.asarray(model.apply(variables, x, train=False))
        arrays[arch] = (logits / SEEDED_HEAD_GAIN).astype(np.float32)
        pipe = OCRPipeline(RecognitionEngine(model, variables, cfg), det,
                           line_cfg)
        per_page = []
        for name, img, _ in pages:
            status, payload = pipe.run_ocr(img,
                                           target_encoding=Encoding.WYLIE)
            if status != OpStatus.SUCCESS:
                raise RuntimeError(f"{arch} {name}: {payload}")
            _, lines, ocr_lines, angle = payload
            per_page.append({
                "name": name,
                "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in lines],
                "jax_f32_texts": [ln.text for ln in ocr_lines],
                "jax_angle": angle,
            })
            print(arch, name, len(lines), "lines", file=sys.stderr)
        record["architectures"][arch] = {"pages": per_page}

    # the eval CLI on the line dataset, full77f in float32
    glyphs, charset = port_synth.load_glyphs(OUT / "pages.npz")
    meta = json.loads((WEIGHTS / "recognizer.msgpack.json").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        port_synth.write_line_dataset(root / "data", port_synth.line_dataset(
            glyphs, charset, LINE_DATASET_SEED, LINE_DATASET_PER_DIST))
        (root / "model").mkdir()
        (root / "model" / "model_config.json").write_text(json.dumps({
            "onnx-model": str(WEIGHTS / "recognizer.onnx"),
            "architecture": "Easter2", "input_width": INPUT_WIDTH,
            "input_height": 80, "input_layer": "input",
            "output_layer": "output", "squeeze_channel_dim": "yes",
            "swap_hw": "no", "encoder": "wylie", "charset": meta["charset"],
            "add_blank": "yes", "version": "full77f"}))
        jax_evaluator.build_recognition_engine = functools.partial(
            jax_evaluator.build_recognition_engine, dtype=jnp.float32)
        evaluate_cli.main(["--model", str(root / "model"), "--dataset",
                           str(root / "data"), "--output", str(root / "out")])
        record["eval_cli"] = {
            "seed": LINE_DATASET_SEED,
            "per_distribution": LINE_DATASET_PER_DIST,
            "weights": "artifacts/full77f", "input_width": INPUT_WIDTH,
            "scores": json.loads((root / "out" / "Easter2.json").read_text()),
            "score_file": (root / "out" / "Easter2.txt").read_text(),
        }
    (OUT / "recognizers.json").write_text(
        json.dumps(record, indent=1, ensure_ascii=False) + "\n",
        encoding="utf-8",
    )
    np.savez_compressed(OUT / "recognizer_logits.npz", **arrays)
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



IMAGES = OUT / "images"
BENCH_JPEG_QUALITY = 0  # set by images(): the quality bench_cfg4.jpg has


def widen(img, depth):
    """An 8-bit image as uint16 of ``depth`` bits, its low bits repeating
    its high ones (as a scan of that depth would not leave them zero)."""
    wide = img.astype(np.uint16)
    return (wide << (depth - 8)) | (wide >> (16 - depth))


def flat_page(img):
    """A fixture page as a clean scan: paper 235, ink 40."""
    ink = img.astype(np.int32).mean(axis=2) <= 128
    return np.where(ink[..., None], 40, 235).astype(np.uint8).repeat(3, 2)


def shifted_page(img: np.ndarray, k: int) -> np.ndarray:
    """A page moved k rows down and 2k columns right on paper (235)."""
    out = np.full(img.shape, 235, np.uint8)
    h, w = img.shape[:2]
    out[k:, 2 * k:] = img[:h - k, :w - 2 * k]
    return out


def write_image_files(pages) -> dict[str, str]:
    """Write the page files and the bench JPEG and JP2; returns {file:
    kind}."""
    import io

    import cv2
    from PIL import Image

    from tests.image_writers import write_adam7_png, write_tiff
    import chip_smoke

    by_name = {name: img for name, img, _ in pages}
    flat = {name: flat_page(img) for name, img in by_name.items()}
    folder = IMAGES / "pages"
    folder.mkdir(parents=True, exist_ok=True)
    for old in folder.iterdir():
        old.unlink()
    kinds = {}

    def jpg(name, img, kind, *params):
        assert cv2.imwrite(str(folder / name), img, list(params))
        kinds[name] = kind

    jpg("clean_a.jpg", by_name["clean_a"][..., ::-1],
        "JPEG q90 4:2:0 baseline", cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111)
    jpg("clean_b.jpg", flat["clean_b"], "JPEG q90 4:4:4 progressive",
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        0x111111, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    jpg("skew_2deg.jpg", flat["skew_2deg"][..., 0],
        "JPEG q90 gray, restart interval 4", cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_RST_INTERVAL, 4)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(np.ascontiguousarray(np.rot90(flat["clean_b"], 1))).save(
        folder / "clean_b_exif6.jpg", "JPEG", quality=90, exif=exif.tobytes())
    kinds["clean_b_exif6.jpg"] = "JPEG q90 (PIL), EXIF orientation 6"
    Image.fromarray(flat["clean_a"]).save(
        folder / "clean_a_lzw.tif", compression="tiff_lzw",
        tiffinfo={317: 2})
    kinds["clean_a_lzw.tif"] = "TIFF LZW, predictor 2, RGB"
    Image.fromarray(flat["skew_2deg"][..., 0]).point(
        lambda v: 255 if v > 128 else 0).convert("1").save(
        folder / "skew_2deg_g4.tif", compression="group4")
    kinds["skew_2deg_g4.tif"] = "TIFF CCITT Group 4, bitonal"
    write_tiff(folder / "clean_b_tiled16.tif", [dict(
        samples=flat["clean_b"][..., :1].astype(np.uint16) * 257, bits=16,
        photometric=1, compression=8, predictor=2, tile=(256, 256))])
    kinds["clean_b_tiled16.tif"] = "TIFF 256x256 tiles, Deflate, " \
        "predictor 2, 16-bit gray"
    write_adam7_png(folder / "clean_a_adam7.png", flat["clean_a"], 2, 8)
    kinds["clean_a_adam7.png"] = "PNG Adam7, RGB"
    for name, kind in variant_files(folder, flat).items():
        kinds[name] = kind
    kinds.update(jpeg2000_bmp_pnm_files(folder, by_name, flat))
    kinds.update(gif_webp_ras_pfm_hdr_files(folder, by_name, flat))
    kinds.update(avif_files(folder, by_name, flat))
    kinds.update(htj2k_files(folder, flat))

    global BENCH_JPEG_QUALITY
    bench = chip_smoke.bench_page(42)[..., ::-1]
    for quality in range(90, 0, -5):
        ok, data = cv2.imencode(".jpg", bench,
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        if data.size <= 400 * 1024:
            break
    BENCH_JPEG_QUALITY = quality
    (IMAGES / "bench_cfg4.jpg").write_bytes(data.tobytes())
    kinds["bench_cfg4.jpg"] = f"JPEG q{quality} 4:2:0 baseline, " \
        "bench.py config 4 page"
    buf = io.BytesIO()
    Image.fromarray(bench[..., ::-1]).save(
        buf, "JPEG2000", irreversible=True, quality_mode="rates",
        quality_layers=[60], progression="RPCL")
    (IMAGES / "bench_cfg4.jp2").write_bytes(buf.getvalue())
    kinds["bench_cfg4.jp2"] = "JP2 9/7 at rate 60, RPCL (Pillow), bench.py " \
        "config 4 page"
    ok, data = cv2.imencode(".webp", bench, [cv2.IMWRITE_WEBP_QUALITY, 75])
    (IMAGES / "bench_cfg4.webp").write_bytes(data.tobytes())
    kinds["bench_cfg4.webp"] = "WebP lossy q75 (cv2), bench.py config 4 page"
    ok, data = cv2.imencode(".avif", bench)
    (IMAGES / "bench_cfg4.avif").write_bytes(data.tobytes())
    kinds["bench_cfg4.avif"] = "AVIF cv2 default, bench.py config 4 page"
    ok, data = cv2.imencode(".avif", widen(bench, 10),
                            [cv2.IMWRITE_AVIF_DEPTH, 10])
    (IMAGES / "bench_cfg4_10bit.avif").write_bytes(data.tobytes())
    kinds["bench_cfg4_10bit.avif"] = "AVIF of 10 bits (cv2 from uint16), " \
        "bench.py config 4 page"
    from tests.image_writers import layered_avif_bytes, ycbcr_planes
    (IMAGES / "bench_cfg4_layered.avif").write_bytes(layered_avif_bytes(
        [ycbcr_planes(shifted_page(bench[..., ::-1], k), "420", 8)
         for k in (1, 0)], qualities=[10, 40], speed=6))
    kinds["bench_cfg4_layered.avif"] = "AVIF layered item (libavif " \
        "extraLayerCount 1): bench.py config 4 page shifted, then as it " \
        "is; an AV1 inter frame"
    kinds.update(bench_htj2k(bench[..., ::-1]))
    return kinds


HT_BENCH_STEP = 6.0  # the bench HTJ2K file's 9/7 quantiser step


def htj2k_files(folder, flat) -> dict[str, str]:
    """The HTJ2K page files (the slice that reads HT code-blocks), written
    by tests/htj2k_writer.py: clean_a_ht53.jph (a JPH file, colr method 5,
    5/3 lossless, cleanup passes only) and skew_2deg_ht97.j2k (a raw
    codestream, 9/7 with SigProp and MagRef passes, 512x512 tiles, two
    layers: half the code-blocks wait for the second, which also brings
    the others' refinement passes). Returns {file: kind}."""
    from tests.htj2k_writer import htj2k_encode, jph_file

    page = flat["clean_a"]
    h, w, _ = page.shape
    (folder / "clean_a_ht53.jph").write_bytes(jph_file(
        htj2k_encode(page), h, w, 3, colr=("cicp", 1, 13, 0, 1)))
    (folder / "skew_2deg_ht97.j2k").write_bytes(htj2k_encode(
        flat["skew_2deg"], reversible=False, passes=3, tile=(512, 512),
        layers=2, split=True, cblk=(5, 5)))
    return {
        "clean_a_ht53.jph": "JPH (colr method 5), HTJ2K 5/3 lossless, "
        "cleanup passes only (tests/htj2k_writer.py)",
        "skew_2deg_ht97.j2k": "J2K codestream HTJ2K 9/7, SigProp and "
        "MagRef passes, 512x512 tiles, 2 layers, 32x32 code-blocks "
        "(tests/htj2k_writer.py)"}


def bench_htj2k(bench) -> dict[str, str]:
    """bench.py config 4's first page (RGB) as an HTJ2K codestream: 9/7
    at step HT_BENCH_STEP, SigProp and MagRef passes, 64x64 code-blocks."""
    from tests.htj2k_writer import htj2k_encode

    (IMAGES / "bench_cfg4_ht.j2k").write_bytes(htj2k_encode(
        bench, reversible=False, passes=3, step=HT_BENCH_STEP))
    return {"bench_cfg4_ht.j2k": f"J2K codestream HTJ2K 9/7 at step "
            f"{HT_BENCH_STEP}, SigProp and MagRef passes "
            "(tests/htj2k_writer.py), bench.py config 4 page"}


def variant_files(folder, flat) -> dict[str, str]:
    """The JPEG and TIFF variants bocr picks up and cv2 reads, one file
    each, of the flattened fixture pages; returns {file: kind}."""
    import cv2
    from PIL import Image

    from tests.image_writers import (
        jpeg_scans, split_jpeg_tables, write_tiff,
    )

    kinds = {}
    Image.fromarray(flat["clean_a"]).convert("CMYK").save(
        folder / "clean_a_cmyk.jpg", "JPEG", quality=70)
    kinds["clean_a_cmyk.jpg"] = "JPEG q70 CMYK (PIL, Adobe inverted)"
    ok, data = cv2.imencode(".jpg", flat["clean_b"], [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    data = data.tobytes()
    start, end, _ = jpeg_scans(data)[-1]
    (folder / "clean_b_cut.jpg").write_bytes(data[: (start + end) // 2])
    kinds["clean_b_cut.jpg"] = "JPEG q90 4:2:0 progressive, cut inside " \
        "its last scan (smoothed)"

    def jpeg(img, sampling):
        ok, out = cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, 80,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        return out.tobytes()

    page = flat["skew_2deg"]
    h, w = page.shape[:2]
    parts = [split_jpeg_tables(jpeg(page[y: y + 64, :, ::-1], 0x221111))
             for y in range(0, h, 64)]
    write_tiff(folder / "skew_2deg_jpeg420.tif", [dict(
        samples=page, bits=8, photometric=6, compression=7,
        rows_per_strip=64, chunks=[b for _, b in parts],
        tags={530: (3, [2, 2]), 347: (7, parts[0][0])})])
    kinds["skew_2deg_jpeg420.tif"] = "TIFF JPEG (7) q80, YCbCr 4:2:0, " \
        "strips of 64 rows, JPEGTables"
    gray = flat["clean_a"][..., 0]
    th = tw = 256
    padded = np.full((-(-gray.shape[0] // th) * th,
                      -(-gray.shape[1] // tw) * tw), 235, np.uint8)
    padded[: gray.shape[0], : gray.shape[1]] = gray
    write_tiff(folder / "clean_a_jpeg_tiles.tif", [dict(
        samples=gray, bits=8, photometric=1, compression=7, tile=(tw, th),
        chunks=[jpeg(padded[y: y + th, x: x + tw], 0x111111)
                for y in range(0, padded.shape[0], th)
                for x in range(0, padded.shape[1], tw)])])
    kinds["clean_a_jpeg_tiles.tif"] = "TIFF JPEG (7) q80, gray, 256x256 " \
        "tiles"
    Image.fromarray(flat["clean_b"]).convert("CMYK").save(
        folder / "clean_b_cmyk.tif", compression="tiff_lzw")
    kinds["clean_b_cmyk.tif"] = "TIFF LZW, CMYK (PIL)"
    rgb = flat["skew_2deg"].astype(np.float64)
    ycc = np.stack([
        rgb @ [0.299, 0.587, 0.114],
        rgb @ [-0.168736, -0.331264, 0.5] + 128,
        rgb @ [0.5, -0.418688, -0.081312] + 128], -1)
    write_tiff(folder / "skew_2deg_ycc22.tif", [dict(
        samples=np.rint(ycc).clip(0, 255).astype(np.uint8), bits=8,
        photometric=6, compression=8, ycbcr_subsampling=(2, 2),
        rows_per_strip=32)])
    kinds["skew_2deg_ycc22.tif"] = "TIFF Deflate, YCbCr 2x2 subsampled"
    write_tiff(folder / "clean_a_planar.tif", [dict(
        samples=flat["clean_a"], bits=8, photometric=2, planar=True,
        compression=5, predictor=2, rows_per_strip=64)])
    kinds["clean_a_planar.tif"] = "TIFF LZW, predictor 2, planar RGB"
    write_tiff(folder / "clean_b_big.tif", [dict(
        samples=flat["clean_b"], bits=8, photometric=2, compression=8,
        predictor=2, rows_per_strip=64)], order=">", big=True)
    kinds["clean_b_big.tif"] = "BigTIFF, big-endian, Deflate, predictor 2, " \
        "RGB"
    kinds.update(damaged_and_variant_files(folder, flat))
    return kinds


def damaged_and_variant_files(folder, flat) -> dict[str, str]:
    """Pages cv2 reads that the port once gave None for or refused by
    name: damaged and cut strips, libtiff's other codecs, CIE L*a*b*,
    arithmetic-coded and lossless JPEG (with subsampled components too);
    and, in images/none/, a 12-bit
    JPEG and a NeXT page, which cv2 gives None for. Returns {file:
    kind}."""
    import io

    from PIL import Image

    from tests.image_writers import (
        _page_chunks, jpeg_arith, jpeg_dct, jpeg_lossless, modified_huffman,
        next_2bit, old_style_lzw, sgilog, thunderscan, write_tiff,
    )

    kinds = {}
    none = IMAGES / "none"
    none.mkdir(parents=True, exist_ok=True)
    for old in none.iterdir():
        old.unlink()

    def pil_strips(img, **save):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **save)
        tags = dict(Image.open(buf).tag_v2)
        raw = buf.getvalue()
        return [raw[o: o + n] for o, n in zip(tags[273], tags[279])], tags

    def bitonal(name):
        return flat[name][..., 0] < 128  # True: ink

    def ccitt_page(ink, comp, chunks, tags, **kw):
        return dict(samples=np.zeros(ink.shape + (1,), np.uint8), bits=1,
                    photometric=tags[262], compression=comp, chunks=chunks,
                    rows_per_strip=tags[278], **kw)

    ink = bitonal("skew_2deg")
    chunks, tags = pil_strips(Image.fromarray(~ink).convert("1"),
                              compression="group4", tiffinfo={278: 64})
    bad = bytearray(chunks[3])
    bad[len(bad) // 2] ^= 0x5A
    chunks[3] = bytes(bad)
    write_tiff(folder / "skew_2deg_g4_damaged.tif",
               [ccitt_page(ink, 4, chunks, tags)])
    kinds["skew_2deg_g4_damaged.tif"] = "TIFF CCITT Group 4, strips of 64 " \
        "rows, one byte of strip 3 changed"
    ink = bitonal("clean_a")
    chunks, tags = pil_strips(Image.fromarray(~ink).convert("1"),
                              compression="group3", tiffinfo={278: 64})
    chunks[4] = chunks[4][: len(chunks[4]) // 2]
    write_tiff(folder / "clean_a_g3_cut.tif",
               [ccitt_page(ink, 3, chunks, tags)])
    kinds["clean_a_g3_cut.tif"] = "TIFF CCITT T.4 1-D, strips of 64 rows, " \
        "strip 4 cut to half"
    page = flat["clean_b"]
    chunks = _page_chunks(page, 8, 8, 2, None, 64, "<", 1)
    chunks[2] = chunks[2][:-1] + bytes([chunks[2][-1] ^ 0xFF])
    write_tiff(folder / "clean_b_deflate_badcheck.tif", [dict(
        samples=page, bits=8, photometric=2, compression=8, predictor=2,
        rows_per_strip=64, chunks=chunks)])
    kinds["clean_b_deflate_badcheck.tif"] = "TIFF Deflate, predictor 2, " \
        "RGB, strip 2's Adler-32 check wrong (its predictor not undone)"
    gray = flat["clean_a"][..., 0]
    write_tiff(folder / "clean_a_oldlzw.tif", [dict(
        samples=gray[..., None], bits=8, photometric=1, compression=5,
        rows_per_strip=64,
        chunks=[old_style_lzw(gray[y: y + 64].tobytes())
                for y in range(0, gray.shape[0], 64)])])
    kinds["clean_a_oldlzw.tif"] = "TIFF old-style (pre-TIFF 6) LZW, gray"
    Image.fromarray(flat["skew_2deg"]).convert("LAB").save(
        folder / "skew_2deg_lab.tif", compression="tiff_lzw")
    kinds["skew_2deg_lab.tif"] = "TIFF CIE L*a*b* 8-bit, LZW (PIL)"
    rgb = flat["clean_a"].astype(np.float64)
    ycc = np.stack([
        rgb @ [0.299, 0.587, 0.114],
        rgb @ [-0.168736, -0.331264, 0.5] + 128,
        rgb @ [0.5, -0.418688, -0.081312] + 128], -1)
    h, w = ycc.shape[:2]
    chroma = [ycc[..., c].reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
              for c in (1, 2)]
    (folder / "clean_a_arith_prog.jpg").write_bytes(jpeg_arith(
        [ycc[..., 0]] + chroma, [(2, 2), (1, 1), (1, 1)], progressive=True,
        restart=64, size=(h, w)))
    kinds["clean_a_arith_prog.jpg"] = "JPEG arithmetic-coded progressive " \
        "(SOF10), 4:2:0, restart interval 64"
    (folder / "clean_b_lossless.jpg").write_bytes(jpeg_lossless(
        flat["clean_b"], 8, 1, restart_rows=8))
    kinds["clean_b_lossless.jpg"] = "JPEG lossless (SOF3), RGB, predictor " \
        "1, restarts every 8 rows"
    page = flat["clean_a"].astype(np.int64)
    half = page[..., 1:].reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    (folder / "clean_a_lossless_h2v2.jpg").write_bytes(jpeg_lossless(
        [page[..., 0], half[..., 0].astype(np.int64),
         half[..., 1].astype(np.int64)], 8, 7, restart_rows=4,
        sampling=[(2, 2), (1, 1), (1, 1)], size=(h, w)))
    kinds["clean_a_lossless_h2v2.jpg"] = "JPEG lossless (SOF3), RGB with " \
        "G and B sampled 2x2 below R, predictor 7, restarts every 4 MCU rows"
    levels = flat["clean_b"][..., 0] >> 4
    write_tiff(folder / "clean_b_thunder.tif", [dict(
        samples=levels[..., None], bits=4, photometric=3, compression=32809,
        rows_per_strip=64, colormap=np.tile(np.arange(16) * 0x1111, 3),
        chunks=[thunderscan(levels[y: y + 64])
                for y in range(0, levels.shape[0], 64)])])
    kinds["clean_b_thunder.tif"] = "TIFF ThunderScan 4-bit, palette"
    ink = bitonal("skew_2deg")
    write_tiff(folder / "skew_2deg_rlew.tif", [dict(
        samples=ink[..., None].astype(np.uint8), bits=1, photometric=0,
        compression=32771, rows_per_strip=1,
        chunks=[modified_huffman(row[None], 16) for row in ink])])
    kinds["skew_2deg_rlew.tif"] = "TIFF CCITT RLE-W, one row a strip"
    lum = ((flat["clean_a"][..., 0].astype(np.float64) + 0.5) / 256) ** 2
    rows = sgilog(lum, False)
    write_tiff(folder / "clean_a_logl.tif", [dict(
        samples=np.zeros(lum.shape + (1,)), bits=16, photometric=32844,
        compression=34676, rows_per_strip=64,
        chunks=[b"".join(rows[y: y + 64]) for y in range(0, len(rows), 64)])])
    kinds["clean_a_logl.tif"] = "TIFF SGI LogL (34676)"
    lum = ((flat["skew_2deg"][..., 0].astype(np.float64) + 0.5) / 256) ** 2
    rows = sgilog(np.repeat(lum[..., None], 3, axis=2), True)
    write_tiff(folder / "skew_2deg_logluv.tif", [dict(
        samples=np.zeros(lum.shape + (3,)), bits=16, photometric=32845,
        compression=34676, rows_per_strip=64,
        chunks=[b"".join(rows[y: y + 64]) for y in range(0, len(rows), 64)])])
    kinds["skew_2deg_logluv.tif"] = "TIFF SGI LogLuv 32-bit (34676)"

    gray = flat["skew_2deg"][..., 0].astype(np.float64)
    (none / "skew_2deg_12bit.jpg").write_bytes(jpeg_dct([gray * 16], 12,
                                                        qscale=2.0))
    kinds["skew_2deg_12bit.jpg"] = "JPEG 12-bit DCT (SOF1), gray: cv2 " \
        "gives None"
    levels = flat["clean_b"][..., 0] >> 6
    write_tiff(none / "clean_b_next.tif", [dict(
        samples=levels[..., None], bits=2, photometric=1, compression=32766,
        chunks=[next_2bit(levels)])])
    kinds["clean_b_next.tif"] = "TIFF NeXT 2-bit RLE, gray: cv2 gives None"
    return kinds


def top_rows(page, rows: int) -> np.ndarray:
    """A page's top ``rows`` rows, its margin and first text lines: the
    pages of the uncompressed formats (a whole page would take megabytes;
    line detection needs about 128 rows of a fixture page to find a
    line)."""
    return np.ascontiguousarray(page[:rows])


def jpeg2000_bmp_pnm_files(folder, by_name, flat) -> dict[str, str]:
    """The JPEG 2000, BMP, PNM and PAM page files (the first slice that
    reads them), one of each kind the tests cover most, and in
    images/none/ one file of each that cv2 gives None for. Returns {file:
    kind}; the bench-size JP2 is written by write_image_files."""
    import io

    from PIL import Image

    from tests.image_writers import (
        bmp_file, bmp_rle8, bmp_rows, jp2_file, openjpeg_encode, pam_file,
        pnm_file,
    )

    kinds = {}
    none = IMAGES / "none"

    def pil_jp2(name, img, kind, **save):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG2000", **save)
        (folder / name).write_bytes(buf.getvalue())
        kinds[name] = kind

    pil_jp2("clean_a_97.jp2", by_name["clean_a"],
            "JP2 9/7 lossy, 3 quality layers, RPCL, 512x512 tiles, 128x128 "
            "precincts, 32x32 code-blocks (Pillow)", irreversible=True,
            quality_mode="rates", quality_layers=[80, 40, 20],
            progression="RPCL", tile_size=(512, 512),
            precinct_size=(128, 128), codeblock_size=(32, 32))
    pil_jp2("clean_b_53.j2k", flat["clean_b"],
            "J2K codestream 5/3 lossless, LRCP (Pillow)", no_jp2=True)
    pil_jp2("skew_2deg_gray.jp2", flat["skew_2deg"][..., 0],
            "JP2 gray, 9/7 at rate 20 (Pillow)", irreversible=True,
            quality_mode="rates", quality_layers=[20])
    rgb = flat["clean_b"].astype(np.float64)
    ycc = np.rint(np.stack([
        rgb @ [0.299, 0.587, 0.114],
        rgb @ [-0.168736, -0.331264, 0.5] + 128,
        rgb @ [0.5, -0.418688, -0.081312] + 128], -1)).clip(0, 255)
    (folder / "clean_b_sycc.jp2").write_bytes(openjpeg_encode(
        ycc.astype(np.int32), jp2=True, color_space=3, tcp_mct=0,
        rates=[10]))
    kinds["clean_b_sycc.jp2"] = "JP2 sYCC 4:4:4 (colr 18), 5/3 at rate 10 " \
        "(OpenJPEG)"
    (folder / "skew_2deg_sop.jp2").write_bytes(openjpeg_encode(
        flat["skew_2deg"], jp2=True, csty=6, tp_on=1, tp_flag=b"R",
        tile=(512, 512), rates=[20, 5], extra=("PLT=YES", "TLM=YES")))
    kinds["skew_2deg_sop.jp2"] = "JP2 with SOP and EPH markers, PLT and " \
        "TLM, tile-parts by resolution, 512x512 tiles, 2 layers (OpenJPEG)"
    (folder / "clean_a_styles.jp2").write_bytes(openjpeg_encode(
        flat["clean_a"], jp2=True, mode=1 | 2 | 4, irreversible=1,
        rates=[30]))
    kinds["clean_a_styles.jp2"] = "JP2 9/7, code-blocks BYPASS|RESET|" \
        "TERMALL (OpenJPEG)"
    gray = flat["clean_a"][..., 0]
    index = (gray > 128).astype(np.uint8)
    palette = np.zeros((2, 4), np.uint8)
    palette[:, :3] = np.array([[40], [235]])
    h, w = index.shape
    (folder / "clean_a_rle8.bmp").write_bytes(bmp_file(
        w, h, 8, bmp_rle8(index), compression=1, clrused=2,
        palette=palette))
    kinds["clean_a_rle8.bmp"] = "BMP RLE8, 2-entry palette"
    band = top_rows(flat["clean_b"], 144)
    (folder / "clean_b_24.bmp").write_bytes(bmp_file(
        band.shape[1], band.shape[0], 24, bmp_rows(band[..., ::-1], 24)))
    kinds["clean_b_24.bmp"] = "BMP 24-bit, the page's top 144 rows"
    band = top_rows(flat["clean_a"], 144)[..., 0]
    (folder / "clean_a_top.pgm").write_bytes(pnm_file(band))
    kinds["clean_a_top.pgm"] = "PGM (P5) 8-bit, the page's top 144 rows"
    band = top_rows(flat["skew_2deg"], 128).astype(np.int64) * 257
    (folder / "skew_2deg_16bit.ppm").write_bytes(pnm_file(band, 65535))
    kinds["skew_2deg_16bit.ppm"] = "PPM (P6) 16-bit, the page's top 128 " \
        "rows"
    band = top_rows(flat["clean_b"], 144)[..., :1]
    (folder / "clean_b_top.pam").write_bytes(pam_file(band,
                                                      tupltype="GRAYSCALE"))
    kinds["clean_b_top.pam"] = "PAM (P7) GRAYSCALE 8-bit, the page's top " \
        "144 rows"

    # cv2 gives None for these
    rgb = flat["clean_a"].astype(np.float64)
    ycc = np.rint(np.stack([
        rgb @ [0.299, 0.587, 0.114],
        rgb @ [-0.168736, -0.331264, 0.5] + 128,
        rgb @ [0.5, -0.418688, -0.081312] + 128], -1)).clip(0, 255)
    (none / "clean_a_sycc420.jp2").write_bytes(openjpeg_encode(
        ycc.astype(np.int32), jp2=True, color_space=3, subsampling=2,
        rates=[10]))
    kinds["clean_a_sycc420.jp2"] = "JP2 sYCC 4:2:0: cv2 gives None " \
        "(subsampled components)"
    buf = io.BytesIO()
    Image.fromarray(flat["clean_b"]).save(buf, "JPEG2000", irreversible=True,
                                          quality_mode="rates",
                                          quality_layers=[40])
    data = buf.getvalue()
    (none / "clean_b_cut.jp2").write_bytes(data[: len(data) * 3 // 5])
    kinds["clean_b_cut.jp2"] = "JP2 9/7 cut to 60%: cv2 gives None " \
        "(OpenJPEG's strict mode)"
    band = top_rows(flat["clean_a"], 16)[..., 0].astype(np.uint16)
    (none / "clean_a_masks.bmp").write_bytes(bmp_file(
        band.shape[1], band.shape[0], 16, band[::-1].astype("<u2").tobytes(),
        compression=3, masks=(0xF00, 0xF0, 0xF)))
    kinds["clean_a_masks.bmp"] = "BMP 16-bit with 4-4-4 BI_BITFIELDS " \
        "masks: cv2 gives None"
    data = pnm_file(top_rows(flat["skew_2deg"], 32)[..., 0])
    (none / "skew_2deg_cut.pgm").write_bytes(data[: len(data) - 100])
    kinds["skew_2deg_cut.pgm"] = "PGM (P5) cut short: cv2 gives None"
    (none / "clean_b_tuple.pam").write_bytes(pam_file(
        top_rows(flat["clean_b"], 32)[..., :1], tupltype="GRAYSCALE_ALPHA"))
    kinds["clean_b_tuple.pam"] = "PAM GRAYSCALE_ALPHA of depth 1: cv2 " \
        "gives None"
    return kinds


def gif_webp_ras_pfm_hdr_files(folder, by_name, flat) -> dict[str, str]:
    """The GIF, WebP, Sun raster, colour PFM and Radiance HDR page files
    (the slice that reads them), one of each kind the tests cover most, and
    in images/none/ one file of each that cv2 gives None for. Returns
    {file: kind}; the bench-size WebP is written by write_image_files."""
    import io

    import cv2
    from PIL import Image

    from tests.image_writers import (
        gif_file, gif_interlace, gif_lzw, pfm_file, riff_chunks, sun_raster,
        sun_rle, sun_rows, webp_encode,
    )

    kinds = {}
    none = IMAGES / "none"
    ink = {name: (page[..., 0] < 128).astype(np.uint8)
           for name, page in flat.items()}

    # GIF: interlaced, a local table over a global one of other colours
    index = ink["clean_a"]
    h, w = index.shape
    (folder / "clean_a_interlaced.gif").write_bytes(gif_file(
        w, h, gif_lzw(gif_interlace(index), 2), 2,
        gct=[[255, 0, 0], [0, 0, 255]], lct=[[235] * 3, [40] * 3],
        interlace=True))
    kinds["clean_a_interlaced.gif"] = "GIF interlaced, a local colour " \
        "table over a global one"
    # an animation whose first frame has transparent marks (they keep the
    # background colour, paper)
    index = ink["clean_b"].copy()
    index[100:110, 50:400] = 2
    frames = []
    for k in range(3):
        f = Image.fromarray(np.roll(index, 7 * k, axis=1), "P")
        f.putpalette([235, 235, 235, 40, 40, 40, 200, 30, 30])
        frames.append(f)
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   transparency=2, background=0, disposal=2, duration=80)
    (folder / "clean_b_anim.gif").write_bytes(buf.getvalue())
    kinds["clean_b_anim.gif"] = "GIF animation of 3 frames with a " \
        "transparent index (Pillow)"

    # WebP: lossy, lossless, lossy with alpha, animated
    assert cv2.imwrite(str(folder / "clean_a_q80.webp"),
                       by_name["clean_a"][..., ::-1],
                       [cv2.IMWRITE_WEBP_QUALITY, 80])
    kinds["clean_a_q80.webp"] = "WebP lossy q80 (cv2)"
    assert cv2.imwrite(str(folder / "clean_b_lossless.webp"),
                       flat["clean_b"], [cv2.IMWRITE_WEBP_QUALITY, 101])
    kinds["clean_b_lossless.webp"] = "WebP lossless (cv2, quality 101)"
    rgba = np.dstack([flat["skew_2deg"],
                      np.where(ink["skew_2deg"], 255, 90).astype(np.uint8)])
    (folder / "skew_2deg_alpha.webp").write_bytes(webp_encode(
        rgba, quality=80, segments=4, filter_type=1, filter_sharpness=2,
        alpha_filtering=2, partitions=2))
    kinds["skew_2deg_alpha.webp"] = "WebP lossy q80 with a lossless ALPH " \
        "chunk, gradient alpha filter, 4 token partitions (libwebp)"
    buf = io.BytesIO()
    pages = [Image.fromarray(flat["clean_a"]),
             Image.fromarray(np.roll(flat["clean_a"], 9, axis=1))]
    pages[0].save(buf, "WEBP", save_all=True, append_images=pages[1:],
                  quality=80, duration=100)
    (folder / "clean_a_anim.webp").write_bytes(buf.getvalue())
    kinds["clean_a_anim.webp"] = "WebP animation of 2 lossy frames (Pillow)"

    # Sun raster: standard type, 1 bit through a 2-entry colour map
    band = top_rows(ink["clean_b"], 144)
    (folder / "clean_b_top.ras").write_bytes(sun_raster(
        band.shape[1], band.shape[0], 1, sun_rows(band, 1), 1, 1,
        bytes([235, 40, 235, 40, 235, 40])))
    kinds["clean_b_top.ras"] = "Sun raster standard type, 1-bit, 2-entry " \
        "colour map, the page's top 144 rows"
    # colour PFM: floats on the 0-255 scale, rounded by the reader
    band = top_rows(flat["skew_2deg"], 128)[:, :384].astype(np.float32)
    band += np.linspace(-0.4, 0.4, band.shape[1], dtype=np.float32)[:, None]
    (folder / "skew_2deg_top.pfm").write_bytes(pfm_file(band, -1.0))
    kinds["skew_2deg_top.pfm"] = "colour PFM, little-endian, the page's " \
        "top-left 128x384"
    # Radiance HDR: cv2 writes run-length scanlines
    assert cv2.imwrite(str(folder / "clean_a_rle.hdr"),
                       flat["clean_a"].astype(np.float32) / 255)
    kinds["clean_a_rle.hdr"] = "Radiance HDR, run-length scanlines (cv2)"

    # cv2 gives None for these
    data = (folder / "clean_a_q80.webp").read_bytes()
    tag, at, size = riff_chunks(data)[-1]
    (none / "clean_a_cut.webp").write_bytes(data[:at + size // 2])
    kinds["clean_a_cut.webp"] = "WebP lossy cut inside its VP8 data: cv2 " \
        "gives None"
    data = bytearray((folder / "clean_a_interlaced.gif").read_bytes())
    start = data.index(b"\x2c") + 10 + 6 + 2
    data[start + 40] = 0xFF  # codes past the table
    (none / "clean_a_badlzw.gif").write_bytes(bytes(data))
    kinds["clean_a_badlzw.gif"] = "GIF with a code past its LZW table: " \
        "cv2 gives None"
    band = top_rows(ink["clean_a"], 64)
    (none / "clean_a_rle.ras").write_bytes(sun_raster(
        band.shape[1], band.shape[0], 1, sun_rle(sun_rows(band, 1)), 2))
    kinds["clean_a_rle.ras"] = "Sun raster byte-encoded (RLE): cv2 5.0 " \
        "gives None"
    return kinds


def avif_files(folder, by_name, flat) -> dict[str, str]:
    """The AVIF page files (the slices that read them): cv2's default
    (speed 9, 4:2:0, CDEF), a lossless strip (quality 100: 4:4:4, the
    identity matrix), a monochrome page, a Pillow 4:4:4 page of 128x128
    superblocks in two tiles, a page with an alpha item, the clean page at
    Pillow's default and the other at cv2's speed 6 (screen-content tools:
    palettes, intra block copies), the scanned page at Pillow's speed 2
    (loop restoration), a clean page of 10 bits and the scanned page of
    12 bits (cv2 from uint16; 12 bits is AV1 profile 2), the other clean
    page in Pillow's 4:2:2 (profile 2), the scanned page with the film
    grain libaom's denoiser estimates, a grid item (libavif: 2x2 cells,
    the output cutting the last row and column) and an image sequence
    (Pillow, three RGBA frames), and in images/none/ an AVIF cut inside
    its AV1 data. Returns {file: kind}; the bench-size AVIFs are written
    by write_image_files."""
    import io

    import cv2
    from PIL import Image

    from tests.image_writers import (
        avif_crop_grid, layered_avif_bytes, libavif_encode_grid,
        ycbcr_planes,
    )

    kinds = {}
    assert cv2.imwrite(str(folder / "clean_a_speed9.avif"),
                       by_name["clean_a"][..., ::-1])
    kinds["clean_a_speed9.avif"] = "AVIF cv2 default (libaom speed 9, " \
        "4:2:0, 64x64 superblocks, CDEF, BT.601 full range)"
    assert cv2.imwrite(str(folder / "clean_b_top_q100.avif"),
                       top_rows(flat["clean_b"], 144),
                       [cv2.IMWRITE_AVIF_QUALITY, 100])
    kinds["clean_b_top_q100.avif"] = "AVIF cv2 quality 100 (lossless: " \
        "4:4:4, identity matrix, WHT), the page's top 144 rows"
    gray = cv2.cvtColor(by_name["skew_2deg"], cv2.COLOR_RGB2GRAY)
    assert cv2.imwrite(str(folder / "skew_2deg_mono.avif"), gray)
    kinds["skew_2deg_mono.avif"] = "AVIF monochrome (cv2 from a gray page)"
    buf = io.BytesIO()
    Image.fromarray(by_name["skew_2deg"]).save(
        buf, "AVIF", subsampling="4:4:4", quality=50, speed=8, tile_cols=1)
    (folder / "skew_2deg_444.avif").write_bytes(buf.getvalue())
    kinds["skew_2deg_444.avif"] = "AVIF Pillow 4:4:4 quality 50 speed 8, " \
        "128x128 superblocks, two tile columns, matrix unspecified"
    bgra = cv2.cvtColor(by_name["clean_b"][..., ::-1], cv2.COLOR_BGR2BGRA)
    bgra[..., 3] = np.where(flat["clean_b"][..., 0] < 128, 255, 120)
    assert cv2.imwrite(str(folder / "clean_b_alpha.avif"), bgra)
    kinds["clean_b_alpha.avif"] = "AVIF with an alpha item (cv2 from " \
        "BGRA), decoded and dropped"
    buf = io.BytesIO()
    Image.fromarray(flat["clean_a"]).save(buf, "AVIF")
    (folder / "clean_a_default.avif").write_bytes(buf.getvalue())
    kinds["clean_a_default.avif"] = "AVIF Pillow default (speed 6, " \
        "screen-content tools: palettes and intra block copies)"
    assert cv2.imwrite(str(folder / "clean_b_speed6.avif"), flat["clean_b"],
                       [cv2.IMWRITE_AVIF_SPEED, 6])
    kinds["clean_b_speed6.avif"] = "AVIF cv2 speed 6 (screen-content " \
        "tools: palettes)"
    scan = cv2.cvtColor(cv2.imread(str(folder / "skew_2deg.jpg")),
                        cv2.COLOR_BGR2RGB)
    buf = io.BytesIO()
    Image.fromarray(scan).save(buf, "AVIF", speed=2)
    (folder / "skew_2deg_speed2.avif").write_bytes(buf.getvalue())
    kinds["skew_2deg_speed2.avif"] = "AVIF Pillow speed 2 of the scanned " \
        "JPEG page (loop restoration: self-guided units)"
    assert cv2.imwrite(str(folder / "clean_a_10bit.avif"),
                       widen(by_name["clean_a"][..., ::-1], 10),
                       [cv2.IMWRITE_AVIF_DEPTH, 10])
    kinds["clean_a_10bit.avif"] = "AVIF of 10 bits (cv2 from uint16, " \
        "4:2:0, profile 0)"
    assert cv2.imwrite(str(folder / "skew_2deg_12bit.avif"),
                       widen(scan[..., ::-1], 12),
                       [cv2.IMWRITE_AVIF_DEPTH, 12])
    kinds["skew_2deg_12bit.avif"] = "AVIF of 12 bits of the scanned JPEG " \
        "page (cv2 from uint16, 4:2:0, profile 2)"
    buf = io.BytesIO()
    Image.fromarray(flat["clean_b"]).save(buf, "AVIF", subsampling="4:2:2")
    (folder / "clean_b_422.avif").write_bytes(buf.getvalue())
    kinds["clean_b_422.avif"] = "AVIF Pillow 4:2:2 (profile 2, 8 bits; " \
        "palettes and intra block copies)"
    buf = io.BytesIO()
    Image.fromarray(scan).save(buf, "AVIF",
                               advanced={"denoise-noise-level": "25"})
    (folder / "skew_2deg_grain.avif").write_bytes(buf.getvalue())
    kinds["skew_2deg_grain.avif"] = "AVIF Pillow of the scanned JPEG page " \
        "denoised by libaom, with the film grain it estimates"
    # a grid: the page padded with paper to 2x2 cells of 576x320, the
    # output cut back to the page (the last row and column of cells cut)
    padded = np.full((640, 1152, 3), 235, np.uint8)
    padded[:576, :1024] = flat["clean_a"]
    cells = [ycbcr_planes(padded[r * 320:(r + 1) * 320,
                                 c * 576:(c + 1) * 576], "420", 8)
             for r in range(2) for c in range(2)]
    (folder / "clean_a_grid.avif").write_bytes(avif_crop_grid(
        libavif_encode_grid(cells, 2, 2, speed=6), 1024, 576))
    kinds["clean_a_grid.avif"] = "AVIF grid item (libavif): 2x2 cells of " \
        "576x320, its output 1024x576 cutting the last row and column"
    # an image sequence: the scanned page first, then the clean ones
    frames = []
    for img in (scan, flat["clean_a"], flat["clean_b"]):
        frame = np.full(scan.shape, 235, np.uint8)  # each on the scan's size
        h, w = min(img.shape[0], scan.shape[0]), img.shape[1]
        frame[:h, :w] = img[:h]
        alpha = np.where(frame[..., 0] < 128, 255, 180).astype(np.uint8)
        frames.append(Image.fromarray(np.dstack([frame, alpha])))
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:])
    (folder / "skew_2deg_seq.avif").write_bytes(buf.getvalue())
    kinds["skew_2deg_seq.avif"] = "AVIF image sequence (Pillow save_all, " \
        "major brand avis) of three RGBA frames, the scanned JPEG page " \
        "first: its colour and alpha tracks' first samples"
    # a layered item (libavif extraLayerCount 2): the page shifted by (4, 2)
    # and (2, 1) pixels, then as it is, at qualities 20, 40 and 80; its
    # second and third layers are AV1 inter frames
    (folder / "clean_a_layered.avif").write_bytes(layered_avif_bytes(
        [ycbcr_planes(shifted_page(flat["clean_a"], k), "420", 8)
         for k in (2, 1, 0)], qualities=[20, 40, 80], speed=6))
    kinds["clean_a_layered.avif"] = "AVIF layered item (libavif " \
        "extraLayerCount 2, a1lx): the page shifted, then as it is; two " \
        "AV1 inter frames"
    data = (folder / "clean_a_speed9.avif").read_bytes()
    (IMAGES / "none" / "clean_a_cut.avif").write_bytes(
        data[:len(data) * 3 // 4])
    kinds["clean_a_cut.avif"] = "AVIF cut inside its AV1 data: cv2 gives " \
        "None"
    return kinds


def images(only: list[str] = ()) -> int:
    """Write tests/data/torch_port/images/ and images.json (see the
    module doc); with ``only`` (paths relative to IMAGES) write every file
    into a temporary folder, keep those and rewrite their entries, the
    rest of images.json as it is."""
    import shutil
    import tempfile

    import jax

    global IMAGES
    jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])
    from ocr_inference_tpu_torch.eval.synthetic import fixture_pages

    pages = fixture_pages(OUT / "pages.npz")
    if only:
        images_dir = IMAGES
        with tempfile.TemporaryDirectory() as tmp:
            IMAGES = Path(tmp)
            (IMAGES / "none").mkdir()
            try:
                kinds = write_image_files(pages)
            finally:
                IMAGES = images_dir
            for rel in only:
                shutil.copyfile(Path(tmp) / rel, IMAGES / rel)
        record = json.loads((OUT / "images.json").read_text(
            encoding="utf-8"))
        return _record_images(record, [IMAGES / rel for rel in only], kinds)
    kinds = write_image_files(pages)
    files = sorted((IMAGES / "pages").iterdir()) + [
        IMAGES / "bench_cfg4.jpg", IMAGES / "bench_cfg4.jp2",
        IMAGES / "bench_cfg4.webp", IMAGES / "bench_cfg4.avif",
        IMAGES / "bench_cfg4_10bit.avif", IMAGES / "bench_cfg4_layered.avif",
        IMAGES / "bench_cfg4_ht.j2k"] + sorted(
        (IMAGES / "none").iterdir())
    total = sum(p.stat().st_size for p in files)
    assert total < 6400 * 1024, f"{total} bytes of image files"
    newest = sum(p.stat().st_size for p in files if p.suffix in (
        ".gif", ".webp", ".ras", ".pfm", ".hdr"))
    assert newest < 1500 * 1024, f"{newest} bytes of the newest formats"
    avif = sum(p.stat().st_size for p in files if p.suffix == ".avif")
    assert avif < 900 * 1024, f"{avif} bytes of AVIF files"
    record = {"bench_jpeg_quality": BENCH_JPEG_QUALITY, "files": {},
              "bocr": {}, "bocr_lines": {}}
    return _record_images(record, files, kinds)


def _record_images(record, files, kinds) -> int:
    """images.json's entries of ``files`` (page files and others): cv2's
    decode of each, the JAX bocr and bocr-lines records of the page files
    among them."""
    import functools

    import cv2
    import jax.numpy as jnp
    import pyarrow.parquet as pq
    import tempfile

    from chip_smoke import globbed_by_folder, renamed_page
    from ocr_inference_tpu.cli import cli as jax_cli
    from ocr_inference_tpu.cli import infer_lines_cli as jax_lines_cli
    from ocr_inference_tpu.core.data import (
        CharsetEncoder, Encoding, LineDetectionConfig, OCRModelConfig,
        OpStatus,
    )
    from ocr_inference_tpu.pipeline import builder as jax_builder
    from ocr_inference_tpu_torch.io.images import read_image
    import chip_smoke

    page_files = [p for p in files if p.parent == IMAGES / "pages"]
    for path in files:
        rel = str(path.relative_to(IMAGES))
        img = cv2.imread(str(path))
        entry = {"kind": kinds[path.name], "bytes": path.stat().st_size,
                 "file_sha256": hashlib.sha256(path.read_bytes()).hexdigest(),
                 "shape": None, "sha256": None}
        if img is None:  # images/none/: cv2 gives None
            assert read_image(path) is None, rel
        else:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            assert np.array_equal(read_image(path), img), rel
            entry.update(shape=list(img.shape), sha256=sha256(img))
        record["files"][rel] = entry
        shape = None if img is None else img.shape
        print(rel, shape, path.stat().st_size, file=sys.stderr)

    ocr_cfg, line_cfg = full77f_configs(OCRModelConfig, LineDetectionConfig,
                                        CharsetEncoder.WYLIE)
    pipe = jax_builder.build_pipeline(ocr_cfg, line_cfg, dtype=jnp.float32)
    f32_build = functools.partial(jax_builder.build_pipeline,
                                  dtype=jnp.float32)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model, lines = chip_smoke.write_model_dirs(tmp)
        jax_cli.build_pipeline = f32_build
        globbed = tmp / "globbed"
        globbed.mkdir()
        for path in page_files:
            if globbed_by_folder(path):
                (globbed / path.name).write_bytes(path.read_bytes())
        if any(globbed.iterdir()):
            rc = jax_cli.main(["--model", str(model), "--folder",
                               str(globbed), "--output", str(tmp / "out"),
                               "--line-model", str(lines),
                               "--encoding", "wylie"])
            assert rc == 0, rc
        for path in page_files:
            if not globbed_by_folder(path):
                rc = jax_cli.main(["--model", str(model), "--image",
                                   str(path), "--output", str(tmp / "out"),
                                   "--line-model", str(lines),
                                   "--encoding", "wylie"])
                assert rc == 0, (path.name, rc)
        for path in page_files:
            img = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
            status, payload = pipe.run_ocr(img, merge_lines=False,
                                           target_encoding=Encoding.WYLIE)
            assert status == OpStatus.SUCCESS, path.name
            _, found, ocr_lines, angle = payload
            text = (tmp / "out" / f"{path.stem}.txt").read_text(
                encoding="utf-8")
            assert text == "".join(f"{ln.text}\n" for ln in ocr_lines), \
                path.name
            record["bocr"][path.name] = {
                "jax_f32_texts": [ln.text for ln in ocr_lines],
                "jax_f32_boxes": [list(ln.bbox.as_tuple()) for ln in found],
                "jax_angle": angle}
            print(path.name, len(ocr_lines), "lines", file=sys.stderr)
        jax_lines_cli.build_detection_engine = functools.partial(
            jax_builder.build_detection_engine, dtype=jnp.float32)
        if any(globbed.iterdir()):
            rc = jax_lines_cli.main(["-i", str(globbed), "-o",
                                     str(tmp / "parquet"), "-c",
                                     str(WEIGHTS / "lines.msgpack"),
                                     "--device", "cpu"])
            assert rc == 0, rc
        # bocr-lines globs the same five extensions: the other page files
        # go through it under a name it globs (cv2 reads by content)
        renamed = tmp / "renamed"
        renamed.mkdir()
        for path in page_files:
            if not globbed_by_folder(path):
                (renamed / renamed_page(path.name)).write_bytes(
                    path.read_bytes())
        rc = jax_lines_cli.main(["-i", str(renamed), "-o",
                                 str(tmp / "parquet"), "-c",
                                 str(WEIGHTS / "lines.msgpack"),
                                 "--device", "cpu"])
        assert rc == 0, rc
        for path in sorted((tmp / "parquet").iterdir()):
            row, = pq.read_table(path).to_pylist()
            row["contours"] = [[[p["x"], p["y"]] for p in c]
                               for c in row["contours"]]
            row["bboxes"] = [[b["x"], b["y"], b["w"], b["h"]]
                             for b in row["bboxes"]]
            record["bocr_lines"][path.name] = row
    (OUT / "images.json").write_text(
        json.dumps(record, ensure_ascii=False, separators=(",", ":")) + "\n",
        encoding="utf-8")
    return 0


# the training record's recipes (tests/data/torch_port/training.json)
REC_SEED, SEG_SEED = 0, 1
REC_STEPS, SEG_STEPS = 5, 3
REC_RECIPE = {"batch": 32, "input_height": 80, "width": 512,
              "degrade_max": 0.7, "shear_max_deg": 0.6,
              "curve_max_amp": 12.0, "geo_prob": 0.35}
REC_OPTIMIZER = {"learning_rate": 3e-4, "total_steps": 3000,
                 "warmup_steps": 100}
SEG_RECIPE = {"batch": 8, "patch": 512}
SEG_OPTIMIZER = {"learning_rate": 3e-4, "total_steps": 400,
                 "warmup_steps": 50}


def _norms(tree, digits: int = 7) -> dict[str, float]:
    """Per leaf ("Mod/Sub/kernel"), its float64 norm to ``digits``
    significant digits."""
    out = {}

    def walk(a, prefix):
        for k in sorted(a):
            if isinstance(a[k], dict):
                walk(a[k], prefix + (k,))
            else:
                n = np.linalg.norm(np.asarray(a[k], np.float64).ravel())
                out["/".join(prefix + (k,))] = float(f"{n:.{digits}g}")

    walk(tree, ())
    return out


def training() -> int:
    """tests/data/torch_port/training.json (see the module docstring)."""
    import time

    import jax
    import jax.numpy as jnp

    from ocr_inference_tpu.eval.synthetic import (
        WYLIE_CHARSET_FULL, GlyphSet, recognizer_batch, segmentation_batch,
    )
    from ocr_inference_tpu.models import UNet, build_recognizer
    from ocr_inference_tpu.training import (
        ctc_loss_fn, make_optimizer, make_seg_train_step, make_train_step,
        seg_loss_fn,
    )
    from ocr_inference_tpu_torch.models.params import read_msgpack

    glyphs = GlyphSet(charset=WYLIE_CHARSET_FULL, height=40, seed=7)
    record = {"charset": "WYLIE_CHARSET_FULL", "glyph_height": 40,
              "glyph_seed": 7}

    def grad_of(model, kind):
        def loss_fn(params, stats, batch):
            logits, _ = model.apply(
                {"params": params, "batch_stats": stats}, batch["images"],
                train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)})
            if kind == "seg":
                return seg_loss_fn(logits, batch["targets"])
            lengths = jnp.minimum(batch["image_widths"] // 4,
                                  logits.shape[1])
            return ctc_loss_fn(logits, lengths, batch["labels"],
                               batch["label_lengths"])
        return jax.jit(jax.grad(loss_fn))

    def run(model, variables, opt, step_fn, kind, batches, tag):
        params, stats = variables["params"], variables["batch_stats"]
        state = (params, stats, opt.init(params), 0)
        grad = grad_of(model, kind)
        out = []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            before = jax.tree.map(np.asarray, state[0])
            grads = grad(state[0], state[1], batch)
            state, loss = step_fn(state, batch)
            after = jax.tree.map(np.asarray, state[0])
            change = jax.tree.map(
                lambda a, b: np.asarray(b, np.float64)
                - np.asarray(a, np.float64), before, after)
            out.append({"loss": float(loss), "change_norms": _norms(change),
                        "grad_norms": _norms(grads)})
            print(f"{kind} {tag} step {i}: loss {float(loss):.6f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return out

    def both(build, weights, optimizer, make_step, kind, batches):
        """The float32 run, then the float64 one (jax.enable_x64, the Flax
        modules at dtype float64; their heads stay float32) on the same
        batches from the same weights."""
        variables = read_msgpack(weights)
        model = build(jnp.float32)
        opt = make_optimizer(**optimizer)
        f32 = run(model, variables, opt, make_step(model, opt), kind,
                  batches, "f32")
        with jax.enable_x64(True):
            model = build(jnp.float64)
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                               variables)
            b64 = [{k: np.asarray(a, np.float64) if a.dtype == np.float32
                    else a for k, a in b.items()} for b in batches]
            opt = make_optimizer(**optimizer)
            f64 = run(model, v64, opt, make_step(model, opt), kind, b64,
                      "f64")
        return [{"batch_sha256": {k: sha256(v) for k, v in b.items()},
                 "loss": s["loss"], "change_norms": s["change_norms"],
                 "grad_norms": s["grad_norms"], "loss_f64": d["loss"],
                 "change_norms_f64": d["change_norms"],
                 "grad_norms_f64": d["grad_norms"]}
                for b, s, d in zip(batches, f32, f64)]

    rng = np.random.RandomState(REC_SEED)
    recipe = dict(REC_RECIPE)
    batch_size = recipe.pop("batch")
    batches = [recognizer_batch(rng, glyphs, WYLIE_CHARSET_FULL, batch_size,
                                **recipe) for _ in range(REC_STEPS)]
    record["rec"] = {
        "weights": "artifacts/full77f/recognizer.msgpack",
        "seed": REC_SEED, "recipe": REC_RECIPE, "optimizer": REC_OPTIMIZER,
        "steps": both(lambda dt: build_recognizer(
            "Easter2", len(WYLIE_CHARSET_FULL) + 1, dtype=dt),
            WEIGHTS / "recognizer.msgpack", REC_OPTIMIZER, make_train_step,
            "rec", batches),
    }
    rng = np.random.RandomState(SEG_SEED)
    batches = [segmentation_batch(rng, glyphs, WYLIE_CHARSET_FULL,
                                  SEG_RECIPE["batch"], SEG_RECIPE["patch"])
               for _ in range(SEG_STEPS)]
    record["seg"] = {
        "weights": "artifacts/full77f/lines.msgpack",
        "seed": SEG_SEED, "recipe": SEG_RECIPE, "optimizer": SEG_OPTIMIZER,
        "steps": both(lambda dt: UNet(classes=1, width=32, stem_stride=2,
                                      dtype=dt),
                      WEIGHTS / "lines.msgpack", SEG_OPTIMIZER,
                      make_seg_train_step, "seg", batches),
    }
    path = OUT / "training.json"
    path.write_text(json.dumps(record, separators=(",", ":")) + "\n",
                    encoding="utf-8")
    print(f"wrote {path} ({path.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

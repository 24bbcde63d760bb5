"""bocr-selftrain, the offline end-to-end accuracy loop, counterpart of
ocr_inference_tpu/cli/selftrain_cli.py:

    python -m ocr_inference_tpu_torch.cli.selftrain_cli --out DIR [options]

Trains Easter2 (recognition, on ``recognizer_batch``) and the UNet (line
detection, on ``segmentation_batch``) on synthetic pecha pages, writes
``recognizer.msgpack`` and ``lines.msgpack`` with their sidecars, then
reads held-out pages through the whole pipeline and writes ``EVAL.json``
with the JAX CLI's keys (CER, per page and, with ``--eval-suite``, per
distribution with a bootstrap CI; the beam and beam+LM columns when
``--lm-order`` > 0). ``--weights DIR`` evaluates earlier weights,
``--weights-rec``/``--weights-seg`` reuse one of them, ``--resume-rec``
fine-tunes the recognizer.

As in the JAX CLI, both nets train with bf16 compute over float32
parameters (Easter2 and UNet at their Flax default ``dtype=bf16``; here
autocast with the float32 heads outside it) and the pipeline reads the
eval pages in bf16. The training batches are binarized on the card by
the ported kernels. Differences: ``--device`` (default ``cuda``; without
a card it raises unless ``cpu`` is given), one device, the port's seeded
initial weights, and ``backend`` in EVAL.json is the torch device type.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "bocr-selftrain",
        description="bocr-selftrain: the offline end-to-end accuracy loop.")
    ap.add_argument("--out", required=True, help="output dir (weights + json)")
    ap.add_argument("--rec-steps", type=int, default=1500)
    ap.add_argument("--seg-steps", type=int, default=400)
    ap.add_argument("--rec-batch", type=int, default=32)
    ap.add_argument("--seg-batch", type=int, default=8)
    ap.add_argument("--eval-pages", type=int, default=16)
    ap.add_argument("--charset", choices=["base", "full"], default="base",
                    help="base = 35 Wylie units; full = 77 units (retroflex "
                         "+ subjoined/superscribed stacks)")
    ap.add_argument("--train-degrade", type=float, default=0.0,
                    help="max ink-dropout/speckle augmentation level on "
                         "recognizer training strips (per-sample U(0, max))")
    ap.add_argument("--train-shear", type=float, default=0.0,
                    help="max rotation (deg) augmentation on training strips")
    ap.add_argument("--train-curve", type=float, default=0.0,
                    help="max vertical-sine amplitude (px) augmentation on "
                         "training strips")
    ap.add_argument("--train-geo-prob", type=float, default=1.0,
                    help="probability a training sample receives the "
                         "geometric (shear/curve) augmentation at all")
    ap.add_argument("--eval-suite", action="store_true",
                    help="evaluate across 6 distributions round-robin over "
                         "--eval-pages, with per-distribution CER and a "
                         "bootstrap 95%% CI on the pooled CER")
    ap.add_argument("--glyph-height", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--json", default=None,
                    help="result json path (default <out>/EVAL.json)")
    ap.add_argument("--unet-width", type=int, default=32)
    ap.add_argument("--unet-stem-stride", type=int, default=2,
                    help="space-to-depth stem UNet variant; 1 = classic stem")
    ap.add_argument("--canvas-width", type=int, default=512)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--lm-order", type=int, default=3,
                    help="char-LM order for the beam+LM eval (0 disables)")
    ap.add_argument("--lm-corpus-lines", type=int, default=500,
                    help="synthetic corpus lines for the n-gram LM")
    ap.add_argument("--lm-alpha", type=float, default=0.5,
                    help="shallow-fusion LM weight (KenLMConfig.alpha)")
    ap.add_argument("--lm-beta", type=float, default=0.0,
                    help="per-token insertion bonus (KenLMConfig.beta)")
    ap.add_argument("--eval-text-dist", choices=["uniform", "markov"],
                    default="uniform",
                    help="markov = sparse-transition text for eval pages AND "
                         "the LM corpus (the recognizer stays trained on "
                         "uniform text)")
    ap.add_argument("--eval-degrade", type=float, default=0.0,
                    help="ink-dropout/speckle level on eval pages (0=clean)")
    ap.add_argument("--lm-tune", action="store_true",
                    help="grid-search (alpha, beta) on a labeled calibration "
                         "sample before the eval; auto-disables fusion if "
                         "no grid point beats the plain beam")
    ap.add_argument("--lm-calib-lines", type=int, default=16,
                    help="calibration strips for --lm-tune")
    ap.add_argument("--weights", default=None,
                    help="reuse trained weights from DIR (recognizer.msgpack"
                         " + lines.msgpack): skip training, eval only")
    ap.add_argument("--weights-rec", default=None,
                    help="reuse only recognizer.msgpack from DIR: skip "
                         "recognizer training, still train the UNet")
    ap.add_argument("--resume-rec", default=None,
                    help="initialize recognizer training from DIR's "
                         "recognizer.msgpack and continue for --rec-steps")
    ap.add_argument("--weights-seg", default=None,
                    help="reuse only lines.msgpack from DIR: skip UNet "
                         "training, still train the recognizer")
    ap.add_argument("--device", default="cuda",
                    help="Device to run on: 'cuda' (default) or 'cpu'")
    return ap


def _copy_weights(src: Path, out: Path, name: str) -> None:
    """``src`` and its sidecar into ``out/name`` unless they are the same
    file."""
    if src.resolve() != (out / name).resolve():
        shutil.copy2(src, out / name)
        side = Path(str(src) + ".json")
        if side.is_file():
            shutil.copy2(side, Path(str(out / name) + ".json"))


def _charset_of(weights: Path, charset, glyphs, height: int):
    """A reused recognizer fixes the charset (its head's vocab), whatever
    --charset says."""
    from ocr_inference_tpu_torch.eval.synthetic import GlyphSet
    from ocr_inference_tpu_torch.models.params import load_meta

    meta = load_meta(weights) or {}
    if meta.get("charset"):
        charset = tuple(meta["charset"])
        glyphs = GlyphSet(charset=charset, height=height, seed=7)
    return charset, glyphs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ocr_inference_tpu_torch.device import resolve_device
    from ocr_inference_tpu_torch.eval.synthetic import (
        WYLIE_CHARSET, WYLIE_CHARSET_FULL, GlyphSet, recognizer_batch,
        segmentation_batch,
    )
    from ocr_inference_tpu_torch.models.params import (
        load_meta, load_params, save_params,
    )
    from ocr_inference_tpu_torch.models.recognition import build_recognizer
    from ocr_inference_tpu_torch.models.segmentation import UNet
    from ocr_inference_tpu_torch.training import (
        init_seg_train_state, init_train_state, make_optimizer,
        make_seg_train_step, make_train_step,
    )

    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    charset = WYLIE_CHARSET_FULL if args.charset == "full" else WYLIE_CHARSET
    glyphs = GlyphSet(charset=charset, height=args.glyph_height, seed=7)
    vocab = len(charset) + 1

    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731

    # 0. eval only: reuse the weights of an earlier run
    if args.weights:
        wdir = Path(args.weights)
        for name in ("recognizer.msgpack", "lines.msgpack"):
            src = wdir / name
            if not src.is_file():
                sys.exit(f"--weights: {src} not found")
            _copy_weights(src, out, name)
        meta = load_meta(out / "lines.msgpack") or {}
        args.unet_width = int(meta.get("width", args.unet_width))
        charset, glyphs = _charset_of(out / "recognizer.msgpack", charset,
                                      glyphs, args.glyph_height)
        log(f"[weights] reusing {wdir} (training skipped)")
        return _run_eval(args, out, charset, glyphs, 0.0, 0.0, 0, 0, log,
                         device)

    # 1. train the recognizer (Easter2, CTC), or reuse one
    rng = np.random.RandomState(args.seed)
    rec_steps_run = args.rec_steps
    if args.weights_rec:
        src = Path(args.weights_rec) / "recognizer.msgpack"
        if not src.is_file():
            sys.exit(f"--weights-rec: {src} not found")
        _copy_weights(src, out, "recognizer.msgpack")
        charset, glyphs = _charset_of(out / "recognizer.msgpack", charset,
                                      glyphs, args.glyph_height)
        rec_loss = 0.0
        rec_steps_run = 0
        log(f"[rec] reusing {src} (recognizer training skipped)")
    else:
        t0 = time.perf_counter()
        if args.resume_rec:
            charset, glyphs = _charset_of(
                Path(args.resume_rec) / "recognizer.msgpack", charset,
                glyphs, args.glyph_height)
            vocab = len(charset) + 1
        rec_model = build_recognizer("Easter2", vocab).to(device)
        rec_opt = make_optimizer(args.lr, total_steps=args.rec_steps,
                                 warmup_steps=min(100, args.rec_steps // 5))
        rec_state = init_train_state(rec_model, rec_opt, input_height=80,
                                     width=args.canvas_width, seed=args.seed)
        if args.resume_rec:
            src = Path(args.resume_rec) / "recognizer.msgpack"
            load_params(rec_model, src)  # in place: the state's tensors
            log(f"[rec] fine-tuning from {src}")
        rec_step = make_train_step(rec_model, rec_opt, dtype=torch.bfloat16)
        state = rec_state.as_tuple()
        loss = torch.tensor(float("nan"))
        for i in range(args.rec_steps):
            batch = recognizer_batch(
                rng, glyphs, charset, args.rec_batch, input_height=80,
                width=args.canvas_width, degrade_max=args.train_degrade,
                shear_max_deg=args.train_shear,
                curve_max_amp=args.train_curve,
                geo_prob=args.train_geo_prob, device=device)
            state, loss = rec_step(state, batch)
            if (i + 1) % args.log_every == 0 or i == 0:
                log(f"[rec] step {i + 1}/{args.rec_steps} loss "
                    f"{float(loss):.4f}")
        rec_loss = float(loss)
        # training provenance travels in the sidecar
        rec_train_meta = {
            "architecture": "Easter2",
            "charset": list(charset),
            "trained_steps": args.rec_steps,
            "train_degrade": args.train_degrade,
            "train_shear": args.train_shear,
            "train_curve": args.train_curve,
            "train_geo_prob": args.train_geo_prob,
        }
        if args.resume_rec:
            rec_train_meta["resumed_from"] = str(args.resume_rec)
            prior = load_meta(
                Path(args.resume_rec) / "recognizer.msgpack") or {}
            lineage = {k: v for k, v in prior.items() if k != "charset"}
            if lineage:
                rec_train_meta["resumed_from_meta"] = lineage
        save_params(rec_model, out / "recognizer.msgpack",
                    meta=rec_train_meta)
        log(f"[rec] trained in {time.perf_counter() - t0:.1f}s; "
            f"loss {rec_loss:.4f}")
        del rec_model, rec_state, state, rec_step

    # 2. train the line-detection UNet, or reuse one
    if args.weights_seg:
        src = Path(args.weights_seg) / "lines.msgpack"
        if not src.is_file():
            sys.exit(f"--weights-seg: {src} not found")
        _copy_weights(src, out, "lines.msgpack")
        meta = load_meta(out / "lines.msgpack") or {}
        args.unet_width = int(meta.get("width", args.unet_width))
        log(f"[seg] reusing {src} (UNet training skipped)")
        return _run_eval(args, out, charset, glyphs, rec_loss, 0.0,
                         rec_steps_run, 0, log, device)
    t0 = time.perf_counter()
    seg_model = UNet(classes=1, width=args.unet_width,
                     stem_stride=args.unet_stem_stride).to(device)
    seg_opt = make_optimizer(args.lr, total_steps=args.seg_steps,
                             warmup_steps=min(50, args.seg_steps // 5))
    seg_state = init_seg_train_state(seg_model, seg_opt, patch_size=512,
                                     seed=args.seed)
    seg_step = make_seg_train_step(seg_model, seg_opt, dtype=torch.bfloat16)
    sstate = seg_state.as_tuple()
    loss = torch.tensor(float("nan"))
    for i in range(args.seg_steps):
        batch = segmentation_batch(rng, glyphs, charset, args.seg_batch,
                                   device=device)
        sstate, loss = seg_step(sstate, batch)
        if (i + 1) % args.log_every == 0 or i == 0:
            log(f"[seg] step {i + 1}/{args.seg_steps} loss {float(loss):.4f}")
    seg_loss = float(loss)
    save_params(seg_model, out / "lines.msgpack",
                meta={"architecture": "unet", "width": args.unet_width,
                      "stem_stride": args.unet_stem_stride})
    log(f"[seg] trained in {time.perf_counter() - t0:.1f}s; "
        f"loss {seg_loss:.4f}")
    del seg_model, seg_state, sstate, seg_step
    return _run_eval(args, out, charset, glyphs, rec_loss, seg_loss,
                     rec_steps_run, args.seg_steps, log, device)


def _describe_recognizer(meta: dict, charset) -> str:
    """The recognizer's provenance line, from its sidecar."""
    parts = [f"{meta.get('architecture', 'Easter2')}, {len(charset)}-unit "
             "Wylie charset"]
    steps = meta.get("trained_steps")
    if steps is not None:
        parts.append(f"{steps} steps")
    augs = []
    if meta.get("train_degrade"):
        augs.append(f"degrade U(0,{meta['train_degrade']:g})")
    if meta.get("train_shear") or meta.get("train_curve"):
        gp = meta.get("train_geo_prob", 1.0)
        augs.append(
            f"shear<={meta.get('train_shear', 0):g}deg/"
            f"curve<={meta.get('train_curve', 0):g}px"
            + (f" at p={gp:g}" if gp is not None and gp < 1.0 else ""))
    if augs:
        parts.append("aug: " + " + ".join(augs))
    if meta.get("resumed_from"):
        parts.append(f"fine-tuned from {meta['resumed_from']}")
    return ", ".join(parts)


def _run_eval(args, out: Path, charset, glyphs, rec_loss, seg_loss,
              rec_steps_run, seg_steps_run, log, device) -> int:
    """Stage 3 (selftrain_cli.py:334-648): the whole pipeline on held-out
    pages -> CER and the result JSON."""
    from ocr_inference_tpu_torch.core.data import (
        CharsetEncoder, KenLMConfig, LineDetectionConfig, OCRModelConfig,
    )
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import MarkovSampler
    from ocr_inference_tpu_torch.models.params import load_meta
    from ocr_inference_tpu_torch.pipeline.builder import build_pipeline

    ocr_config = OCRModelConfig(
        model_file=str(out / "recognizer.onnx"),  # .msgpack found beside it
        architecture="Easter2", input_width=args.canvas_width,
        input_height=80, input_layer="input", output_layer="output",
        squeeze_channel=True, swap_hw=False, encoder=CharsetEncoder.WYLIE,
        charset=list(charset), add_blank=True, version="selftrain",
    )
    line_config = LineDetectionConfig(
        checkpoint="", onnx_file=str(out / "lines.onnx"),
        architecture="unet", patch_size=512, classes=["line"],
    )
    token_sampler = (MarkovSampler(charset)
                     if args.eval_text_dist == "markov" else None)

    kenlm_cfg = None
    if args.lm_order > 0:
        arpa = suite.build_eval_lm(
            out / "lm.arpa", charset, seed=args.seed, order=args.lm_order,
            corpus_lines=args.lm_corpus_lines, token_sampler=token_sampler)
        kenlm_cfg = KenLMConfig(kenlm_file=str(arpa), arpa_file=str(arpa),
                                unigrams=None, alpha=args.lm_alpha,
                                beta=args.lm_beta)
        log(f"[lm] built order-{args.lm_order} ARPA from "
            f"{args.lm_corpus_lines} lines -> {arpa}")

    # the UNet's width and stem travel in its sidecar
    pipeline = build_pipeline(ocr_config, line_config,
                              kenlm_config=kenlm_cfg, device=device)

    lm_report = None
    if args.lm_tune and kenlm_cfg is not None:
        t_cal = time.perf_counter()
        strips, refs, _, _ = suite.calibration_strips(
            pipeline, glyphs, charset, n_lines=args.lm_calib_lines,
            seed=args.seed, token_sampler=token_sampler,
            degrade=args.eval_degrade)
        lm_report = pipeline.ocr_inference.calibrate_lm(strips, refs)
        log(f"[lm] calibration ({time.perf_counter() - t_cal:.1f}s, "
            f"{len(strips)} pipeline-extracted lines): "
            f"{ {k: v for k, v in lm_report.items() if k != 'grid'} }")

    def on_page(page, pred):
        page_cer = cer([pred], [" ".join(page.texts)])
        log(f"[eval] page {page.index + 1}/{args.eval_pages} CER "
            f"{page_cer:.4f}" + (f" [{page.dist}]" if args.eval_suite
                                 else ""))

    t0 = time.perf_counter()
    res = suite.run_suite(pipeline, args.eval_pages, glyphs, charset,
                          on_page=on_page, seed=args.seed,
                          token_sampler=token_sampler,
                          suite=args.eval_suite, degrade=args.eval_degrade)
    eval_s = time.perf_counter() - t0

    # provenance is generated from the weight sidecars and the arguments
    seg_meta = load_meta(out / "lines.msgpack") or {}
    rec_meta = load_meta(out / "recognizer.msgpack") or {}
    provenance = {
        "detector": (
            f"{seg_meta.get('architecture', 'unet')} "
            f"width={seg_meta.get('width', args.unet_width)} "
            f"stem_stride={seg_meta.get('stem_stride', 1)} "
            f"({out / 'lines.msgpack'})"),
        "recognizer": (_describe_recognizer(rec_meta, charset)
                       + f" ({out / 'recognizer.msgpack'})"),
        "recognizer_meta": {k: v for k, v in rec_meta.items()
                            if k != "charset"},
    }
    result = {
        "cer": round(res.cer, 5),
        "pages": args.eval_pages,
        "failed_pages": len(res.failed_pages),
        "lines_detected": res.lines_detected,
        "rec_steps": rec_steps_run,
        "seg_steps": seg_steps_run,
        "rec_loss": round(rec_loss, 5),
        "seg_loss": round(seg_loss, 5),
        "eval_seconds": round(eval_s, 2),
        "per_page_cer": [round(c, 4) for c in res.per_page_cer],
        "charset_size": len(charset),
        "backend": device.type,
        "provenance": provenance,
    }
    if args.eval_suite:
        lo, hi = res.cer_ci95
        result["cer_ci95"] = [round(lo, 5), round(hi, 5)]
        result["per_distribution"] = {
            name: {"pages": d["pages"], "cer": round(d["cer"], 5)}
            for name, d in res.per_distribution.items()}
    if args.eval_text_dist != "uniform":
        result["eval_text_dist"] = args.eval_text_dist
    if args.eval_degrade:
        result["eval_degrade"] = args.eval_degrade
    if kenlm_cfg is not None:
        dec_lm = pipeline.ocr_inference.ctc_decoder_lm
        result["cer_beam"] = round(res.cer_beam, 5)
        result["cer_beam_lm"] = round(res.cer_beam_lm, 5)
        result["lm_order"] = args.lm_order
        result["lm_alpha"] = dec_lm.lm_alpha if dec_lm else args.lm_alpha
        result["lm_beta"] = dec_lm.lm_beta if dec_lm else args.lm_beta
        result["lm_fusion_enabled"] = pipeline.ocr_inference.lm_fusion_enabled
        if lm_report is not None:
            result["lm_calibration"] = lm_report
    json_path = Path(args.json) if args.json else out / "EVAL.json"
    json_path.write_text(json.dumps(result) + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

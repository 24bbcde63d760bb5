"""The six-distribution eval suite's pages on one NVIDIA card, in bf16 and
in float32, against the JAX package's float32 record.

    python3 probe_eval.py

Builds the kernels as chip_smoke.py does, then for each dtype (bf16, as
build_pipeline defaults to, and float32 with TF32 off) builds the pipeline
with the eval LM (artifacts/full77f/lm.arpa, the eval CLI's), calibrates
its fusion on the CLI's 16 calibration strips, reads the 150 seed-5 eval
pages (EVAL_r05's pages) through eval/suite.py ``run_suite`` with the eval
CLI's recognizer canvas of 512 (greedy, plain top beam, fused top beam),
and prints one JSON line: every page's bytes against the sha256 in
tests/data/torch_port/eval_suite.json; the pooled CER with its bootstrap
95% CI, the CER per distribution and per page; the CER of the texts
against the JAX float32 texts of the record (pooled, per distribution,
and the pages whose texts differ); lines read, failed pages, the pages
the TPS dewarp was applied to; seconds and pages/s; and the JAX float32
texts' own CER against the ground truth, pooled and per distribution;
the LM columns (``cer_beam``, ``cer_beam_lm``, ``lm_order``, the fusion
weights, ``lm_fusion_enabled``, ``lm_calibration``), the calibration's
seconds, and the beam texts' CER against the JAX float32 beam texts.
Before them, EVAL_r05's CER and LM columns (the TPU run: EVAL_r05.json,
artifacts/full77f/EVAL.json).
Then the card's name and power limit, and ``{"ok": ...}`` last.

Exits 1 if a page's bytes differ from the JAX page's or the float32 texts
are more than 0.5% CER from the JAX float32 texts, and 2 without CUDA.
Imports torch, numpy, chip_smoke and the port; nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as cs

CANVAS = 512  # cli/selftrain_cli.py --canvas-width default
PAGES = 150


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def by_distribution(dists: list, preds: list, refs: list) -> dict:
    from ocr_inference_tpu_torch.eval.cer import cer

    out = {}
    for name in dict.fromkeys(dists):
        sel = [i for i, d in enumerate(dists) if d == name]
        out[name] = cer([preds[i] for i in sel], [refs[i] for i in sel])
    return out


def read_suite(pipe, n_pages: int, record: list) -> dict:
    from ocr_inference_tpu_torch.eval import suite
    from ocr_inference_tpu_torch.eval.cer import cer
    from ocr_inference_tpu_torch.eval.synthetic import load_glyphs

    glyphs, charset = load_glyphs(cs.FIXTURE / "pages.npz")
    t0 = time.perf_counter()
    calibration = suite.calibrate(pipe, glyphs, charset)
    calibrate_s = time.perf_counter() - t0
    bad_bytes = []

    def check(page, _):
        if cs.sha256(page.image) != record[page.index]["sha256"]:
            bad_bytes.append(page.index)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = suite.run_suite(pipe, n_pages, glyphs, charset, on_page=check)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    jax = [p["jax_f32_text"] for p in record[:n_pages]]
    jax_beam = [p["jax_f32_beam_text"] for p in record[:n_pages]]
    jax_beam_lm = [p["jax_f32_beam_lm_text"] for p in record[:n_pages]]
    return {
        **suite.lm_columns(pipe, res, calibration),
        "calibrate_s": calibrate_s,
        "beam_cer_vs_jax_f32_beam": cer(res.beam_predictions, jax_beam),
        "fused_cer_vs_jax_f32_fused": cer(res.beam_lm_predictions,
                                          jax_beam_lm),
        "jax_f32_cer_beam": cer(jax_beam, res.references),
        "jax_f32_cer_beam_lm": cer(jax_beam_lm, res.references),
        "pages": n_pages, "seconds": dt, "pages_per_s": n_pages / dt,
        "pages_with_other_bytes": bad_bytes,
        "cer": res.cer, "cer_ci95": list(res.cer_ci95),
        "per_distribution": {k: v["cer"]
                             for k, v in res.per_distribution.items()},
        "cer_vs_jax_f32": cer(res.predictions, jax),
        "cer_vs_jax_f32_by_distribution": by_distribution(
            res.dists, res.predictions, jax),
        "jax_f32_cer": cer(jax, res.references),
        "jax_f32_per_distribution": by_distribution(
            res.dists, jax, res.references),
        "pages_differing_from_jax_f32": [
            i for i, (a, b) in enumerate(zip(res.predictions, jax))
            if a != b],
        "lines_detected": res.lines_detected,
        "failed_pages": res.failed_pages,
        "tps_applied_pages": res.tps_applied_pages,
        "per_page_cer": res.per_page_cer,
    }


def eval_r05() -> dict:
    """EVAL_r05's pooled and per-distribution CER (EVAL_r05.json) and its
    LM columns (artifacts/full77f/EVAL.json, the same TPU run of the same
    150 pages)."""
    r05 = json.loads((cs.REPO / "EVAL_r05.json").read_text())
    lm = json.loads((cs.WEIGHTS / "EVAL.json").read_text())
    return {"cer": r05["cer"], "cer_ci95": r05["cer_ci95"],
            "per_distribution": {k: v["cer"]
                                 for k, v in r05["per_distribution"].items()},
            **{k: lm[k] for k in ("cer_beam", "cer_beam_lm", "lm_order",
                                   "lm_alpha", "lm_beta",
                                   "lm_fusion_enabled", "lm_calibration")}}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_eval: CUDA is not available", file=sys.stderr)
        return 2
    cs.build()
    if cs.FAILED:
        return 1
    record = cs.eval_record()["pages"]
    out = {"eval_r05": eval_r05(), "gpu": cs.gpu_name_and_limit()}
    emit({"probe": "eval_r05", **out["eval_r05"]})

    bf16 = cs.eval_lm_pipeline(torch.bfloat16, input_width=CANVAS)
    out["bf16"] = read_suite(bf16, PAGES, record)
    emit({"probe": "bf16", **out["bf16"]})
    del bf16
    f32 = cs.eval_lm_pipeline(torch.float32, input_width=CANVAS)
    with cs.no_tf32():
        out["float32"] = read_suite(f32, PAGES, record)
    emit({"probe": "float32", **out["float32"]})

    ok = (not out["bf16"]["pages_with_other_bytes"]
          and not out["float32"]["pages_with_other_bytes"]
          and out["float32"]["cer_vs_jax_f32"] <= 0.005
          and out["float32"]["beam_cer_vs_jax_f32_beam"] <= 0.005)
    print(out["gpu"], flush=True)
    emit({"ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The slice as a whole on the CPU in float32: the full77f line detector
with a seeded recognizer of each other architecture (Easter2-Attention,
Easter2-Vit, CRNN, at reduced width, weights written as a msgpack with its
sidecar so that both builders read the same file) through run_ocr and
VolumeRunner in both packages, on one fixture page. Status, line count,
boxes and texts must be equal. A text may differ only where a frame's top
two logits lie within 1e-4 and flip; such frames are counted and listed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.models.params import save_params
from ocr_inference_tpu.pipeline import VolumeRunner as JaxVolumeRunner
from ocr_inference_tpu.pipeline.builder import (
    build_detection_engine as jax_detector,
    build_recognition_engine as jax_recognizer,
)
from ocr_inference_tpu.pipeline.ocr_pipeline import OCRPipeline as JaxPipeline
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.models.recognition import build_recognizer
from ocr_inference_tpu_torch.ops.kernels import binarize_lines_plain
from ocr_inference_tpu_torch.pipeline import (
    OCRPipeline,
    PipelineObserver,
    VolumeRunner,
)
from ocr_inference_tpu_torch.pipeline.builder import (
    build_detection_engine,
    build_recognition_engine,
    seeded_variables,
)
from tests.make_torch_port_fixture import OUT, full77f_configs

SEED = 6
REDUCED = {"Easter2-Attention": {"width_mult": 0.125, "stem_features": 16},
           "Easter2-Vit": {"width_mult": 0.125, "stem_features": 16},
           "CRNN": {"hidden": 32}}
TIE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def page():
    name, img, _ = fixture_pages(OUT / "pages.npz")[0]
    return name, img


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{arch: model_file}: X.onnx configured, X.msgpack + X.msgpack.json
    beside it, as the builders look for them."""
    root = tmp_path_factory.mktemp("recognizers")
    ocr, _ = full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                             data.CharsetEncoder.WYLIE)
    out = {}
    for arch, kwargs in REDUCED.items():
        model = build_recognizer(arch, len(ocr.charset) + 1, **kwargs)
        save_params(seeded_variables(model, SEED), root / f"{arch}.msgpack",
                    {"architecture": arch, **kwargs})
        out[arch] = str(root / f"{arch}.onnx")
    return out


@pytest.fixture(scope="module")
def detectors():
    """The full77f line detector of each package, shared by the
    recognizers."""
    _, theirs = full77f_configs(jdata.OCRModelConfig,
                                jdata.LineDetectionConfig,
                                jdata.CharsetEncoder.WYLIE)
    _, ours = full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                              data.CharsetEncoder.WYLIE)
    return ((jax_detector(theirs, dtype=jnp.float32), theirs),
            (build_detection_engine(ours, dtype=torch.float32,
                                    device="cpu"), ours))


def _pipelines(arch, weights, detectors):
    (jdet, jline), (pdet, pline) = detectors
    jcfg, _ = full77f_configs(jdata.OCRModelConfig, jdata.LineDetectionConfig,
                              jdata.CharsetEncoder.WYLIE)
    pcfg, _ = full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                              data.CharsetEncoder.WYLIE)
    for cfg in (jcfg, pcfg):
        cfg.architecture, cfg.model_file = arch, weights[arch]
    jrec = jax_recognizer(jcfg, dtype=jnp.float32)
    prec = build_recognition_engine(pcfg, dtype=torch.float32, device="cpu")
    return JaxPipeline(jrec, jdet, jline), OCRPipeline(prec, pdet, pline)


def _flips(theirs, ours, strip) -> list[tuple[int, float, float]]:
    """The frames of one strip whose greedy ids differ between the
    packages, each with the top-two gap of both sides' logits, on the
    port's canvas of the strip."""
    canvas = ours.ocr_inference.prepare_canvas(strip)
    bw = binarize_lines_plain(torch.from_numpy(canvas)[None])
    x = bw.to(torch.float32) / 127.5 - 1.0
    with torch.no_grad():
        mine = ours.ocr_inference.model(x)[0].numpy()
    rec = theirs.ocr_inference
    want = np.asarray(rec.model.apply(rec.variables, x.numpy(),
                                      train=False))[0]

    def gap(row):
        top = np.sort(row)[-2:]
        return float(top[1] - top[0])

    return [(t, gap(want[t]), gap(mine[t]))
            for t in np.flatnonzero(mine.argmax(-1) != want.argmax(-1))]


def _check_lines(texts, want_texts, theirs, ours, strips) -> list:
    """Equal texts, or differences explained by near-tie frames only;
    returns the flipped frames as (line, frame, gap_jax, gap_port)."""
    flipped = []
    for i, (got, want) in enumerate(zip(texts, want_texts)):
        if got == want:
            continue
        frames = _flips(theirs, ours, strips[i])
        assert frames and all(min(g) < TIE for _, *g in frames), (
            f"line {i}: {got!r} != {want!r}; frames {frames}")
        flipped += [(i, *f) for f in frames]
    return flipped


class _Strips(PipelineObserver):
    strips = None

    def stage_end(self, stage, payload):
        if stage == "extract_lines":
            self.strips = payload[1]


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_run_ocr_and_volume_match_jax(arch, weights, detectors, page):
    theirs, ours = _pipelines(arch, weights, detectors)
    name, img = page
    obs = _Strips()
    jstatus, jpay = theirs.run_ocr(img, target_encoding=jdata.Encoding.WYLIE)
    status, pay = ours.run_ocr(img, target_encoding=data.Encoding.WYLIE,
                               observer=obs)
    assert (status.name, jstatus.name) == ("SUCCESS", "SUCCESS")
    boxes = [ln.bbox.as_tuple() for ln in pay[1]]
    assert boxes == [ln.bbox.as_tuple() for ln in jpay[1]]
    assert len(boxes) > 0
    assert pay[3] == pytest.approx(jpay[3], abs=1e-6)
    want_texts = [ln.text for ln in jpay[2]]
    flipped = _check_lines([ln.text for ln in pay[2]], want_texts, theirs,
                           ours, obs.strips)
    # seeded recognizers read random tokens, the same in both packages
    assert any(want_texts)

    jrec, = JaxVolumeRunner(theirs, window_pages=1).run(
        [(name, img)], target_encoding=jdata.Encoding.WYLIE)
    rec, = VolumeRunner(ours, window_pages=1).run(
        [(name, img)], target_encoding=data.Encoding.WYLIE)
    assert (rec.status.name, jrec.status.name) == ("SUCCESS", "SUCCESS")
    assert [ln.bbox.as_tuple() for ln in rec.lines] == [
        ln.bbox.as_tuple() for ln in jrec.lines] == boxes
    flipped += _check_lines([ln.text for ln in rec.ocr_lines],
                            [ln.text for ln in jrec.ocr_lines], theirs, ours,
                            obs.strips)
    print(f"{arch}: {len(flipped)} near-tie frames flipped: {flipped}")


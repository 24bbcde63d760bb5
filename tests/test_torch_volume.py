"""The port's VolumeRunner (on the CPU, float32, full77f weights) against
the JAX package's VolumeRunner on the same pages, and the cases of
tests/test_volume.py on the port's own engines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_inference_tpu.core import data as jdata
from ocr_inference_tpu.pipeline import VolumeRunner as JaxVolumeRunner
from ocr_inference_tpu.pipeline.builder import build_pipeline as jax_build
from ocr_inference_tpu_torch.core import data
from ocr_inference_tpu_torch.device import DeviceFault
from ocr_inference_tpu_torch.eval.synthetic import fixture_pages
from ocr_inference_tpu_torch.pipeline import VolumeRunner, build_pipeline
from tests.make_torch_port_fixture import OUT, full77f_configs

OK, FAILED = data.OpStatus.SUCCESS, data.OpStatus.FAILED


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; two intra-op
    threads each keep them from oversubscribing the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pages():
    return [(name, img) for name, img, _ in fixture_pages(OUT / "pages.npz")]


@pytest.fixture(scope="module")
def pipe():
    return build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE),
        dtype=torch.float32, device="cpu",
    )


def _raising_loader():
    raise IOError("corrupt file")


def _blank(pages):
    return np.full(pages[0][1].shape, 235, np.uint8)


def _mixed_volume(pages):
    """The three fixture pages, a blank page, a None and a loader that
    raises."""
    return pages + [("blank", _blank(pages)), ("none", None),
                    ("bad", _raising_loader)]


def _summary(records):
    return [
        (r.name, r.status.name, r.angle,
         [ln.bbox.as_tuple() for ln in r.lines],
         [ln.text for ln in r.ocr_lines])
        for r in records
    ]


@pytest.fixture(scope="module")
def jax_volume(pages):
    theirs = jax_build(
        *full77f_configs(jdata.OCRModelConfig, jdata.LineDetectionConfig,
                         jdata.CharsetEncoder.WYLIE),
        dtype=jnp.float32,
    )
    runner = JaxVolumeRunner(theirs, window_pages=2, max_held_pages=1)
    records = runner.run(_mixed_volume(pages),
                         target_encoding=jdata.Encoding.WYLIE)
    return records, dict(theirs.ocr_inference.occupancy)


def test_volume_matches_jax_volume_runner(pipe, pages, jax_volume):
    want, want_occupancy = jax_volume
    pipe.ocr_inference.occupancy.clear()
    runner = VolumeRunner(pipe, window_pages=2, max_held_pages=1)
    got = runner.run(_mixed_volume(pages), target_encoding=data.Encoding.WYLIE)
    assert _summary(got) == _summary(want)
    assert [r.error for r in got] == [r.error for r in want]
    assert [r.status.name for r in got] == \
        ["SUCCESS"] * 3 + ["FAILED"] * 3
    assert pipe.ocr_inference.occupancy.keys() == want_occupancy.keys()
    for r, w in zip(got[:3], want):
        np.testing.assert_array_equal(r.mask, w.mask)
        assert {"detect_dispatch", "detect", "geometry", "recognize"} <= \
            r.timings_ms.keys()


def test_volume_runner_processes_pages_in_order(pipe, pages):
    runner = VolumeRunner(pipe, window_pages=2)
    vol = [(f"p{i}", pages[i][1]) for i in range(3)]
    done = []
    results = runner.run(vol, on_page_done=lambda r: done.append(r.name))
    assert [r.name for r in results] == [f"p{i}" for i in range(3)]
    assert done == [r.name for r in results]
    for rec in results:
        assert rec.status == OK, rec.error
        assert len(rec.ocr_lines) == len(rec.lines) > 0
        ys = [ln.center[1] for ln in rec.lines]
        assert ys == sorted(ys)


def test_volume_runner_lazy_loaders(pipe, pages):
    calls = []

    def loader(i):
        def load():
            calls.append(i)
            return pages[i][1]
        return load

    results = VolumeRunner(pipe, window_pages=4).run(
        [(f"p{i}", loader(i)) for i in range(3)])
    assert sorted(calls) == [0, 1, 2]
    assert all(r.status == OK for r in results)


def test_volume_streaming_shapes_closed_after_warm(pipe, pages):
    """Every forward of a streaming run has a shape of the closed set
    that warm_shapes() runs: {power of two < quantum, quantum} per
    bucket."""
    rec = pipe.ocr_inference
    widths = (512, 1024)
    assert rec.warm_shapes(widths=widths, quantum=8) == 2 * 4
    warmed = {(w, b) for w in widths for b in (1, 2, 4, 8)}
    rec.occupancy.clear()
    vol = [(f"p{i}", pages[i % 3][1]) for i in range(4)]
    results = VolumeRunner(pipe, window_pages=2, stream_quantum=8).run(vol)
    assert [r.name for r in results] == [f"p{i}" for i in range(4)]
    assert all(r.status == OK for r in results)
    used = {(w, b) for (w, _, b) in rec.occupancy}
    assert used and used <= warmed, (used, warmed)
    assert sum(n * c for (_, n, _), c in rec.occupancy.items()) == \
        sum(len(r.lines) for r in results)


def test_volume_streaming_bounded_holding(pipe, pages):
    """max_held_pages=1 forces carried buckets to flush so no page waits
    behind the carry: every record still completes, in order."""
    runner = VolumeRunner(pipe, window_pages=1, max_held_pages=1)
    vol = [(f"h{i}", pages[i][1]) for i in range(3)]
    done_order = []
    results = runner.run(vol, on_page_done=lambda r: done_order.append(r.name))
    assert [r.name for r in results] == [f"h{i}" for i in range(3)]
    assert done_order == [r.name for r in results]
    assert all(r.status == OK for r in results)


def test_volume_runner_stress_mixed_failures(pipe, pages):
    """Pages with interleaved failure modes (None images, raising loaders,
    blanks, a gray page the detector rejects, strided views) keep order,
    isolation and the overlap plumbing intact across several windows and
    geometry workers."""
    runner = VolumeRunner(pipe, window_pages=4, geometry_workers=3)
    blank = _blank(pages)
    vol, expected_ok = [], set()
    for i in range(10):
        name = f"s{i:02d}"
        kind = i % 5
        if kind == 0:
            vol.append((name, None))
        elif kind == 1:
            vol.append((name, _raising_loader))
        elif kind == 2:
            vol.append((name, blank if i % 2 else blank[..., 0]))
        else:
            img = pages[i % 3][1]
            if kind == 4:  # the BGR->RGB idiom: a negative channel stride
                img = np.ascontiguousarray(img[..., ::-1])[..., ::-1]
            vol.append((name, img))
            expected_ok.add(name)
    results = runner.run(vol)
    assert [r.name for r in results] == [f"s{i:02d}" for i in range(10)]
    for r in results:
        if r.name in expected_ok:
            assert r.status == OK, (r.name, r.error)
            assert r.ocr_lines
        else:
            assert r.status == FAILED and r.error
    gray = results[2]  # blank[..., 0]: rejected when it is queued
    assert "expected an (H, W, 3) uint8 page" in gray.error


@pytest.mark.parametrize("where", ["detect", "recognize"])
def test_device_fault_ends_the_volume(pipe, pages, monkeypatch, where):
    """A CUDA error is sticky: it ends the run instead of failing pages."""
    if where == "detect":
        target, name = pipe.line_inference, "predict_async"
    else:
        target, name = pipe.ocr_inference, "stream_run"
    real = getattr(target, name)
    calls = []

    def faulty(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise DeviceFault("CUDA error 700: an illegal memory access")
        return real(*args, **kwargs)

    monkeypatch.setattr(target, name, faulty)
    vol = [(f"p{i}", pages[i][1]) for i in range(3)]
    with pytest.raises(DeviceFault):
        VolumeRunner(pipe, window_pages=1).run(vol)


def test_easter2_runs_fixed_size_calls(pipe, pages, monkeypatch):
    """Every Easter2 call has MODEL_BATCH canvases whatever the logical
    batch, so a line's text cannot depend on the lines that share its
    batch (cuDNN picks its algorithm by the batch size)."""
    rec = pipe.ocr_inference
    seen = []
    real = rec.model.forward

    def spy(x):
        seen.append(x.shape[0])
        return real(x)

    monkeypatch.setattr(rec.model, "forward", spy)
    canvas = np.zeros((rec.config.input_height, 512), np.uint8)
    for padded in (1, 2, 4, 8, 16, 24, 32):
        seen.clear()
        n = max(1, padded - 1)
        rec._texts(range(n), rec._dispatch(512, [canvas] * n, padded))
        assert seen == [rec.MODEL_BATCH] * -(-padded // rec.MODEL_BATCH)


@pytest.mark.cuda
def test_bf16_line_texts_do_not_depend_on_batch_neighbours():
    """On the card in bf16: the same line canvases read in logical batches
    of 32 and of 8, and with other neighbours, give the same texts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    pipe = build_pipeline(
        *full77f_configs(data.OCRModelConfig, data.LineDetectionConfig,
                         data.CharsetEncoder.WYLIE))
    rec = pipe.ocr_inference
    canvases = []
    for _, img, _ in fixture_pages(OUT / "pages.npz"):
        _, mask = pipe.detect_lines(img)
        _, (rot_img, rot_mask, _, filtered, _) = pipe.build_lines(img, mask)
        _, (_, strips) = pipe.extract_lines(rot_img, rot_mask, filtered)
        canvases += [rec.prepare_canvas(s) for s in strips]
    width = canvases[0].shape[1]
    same = [c for c in canvases if c.shape[1] == width]

    def read(cs, batch):
        out = []
        for start in range(0, len(cs), batch):
            chunk = cs[start: start + batch]
            out += list(rec._texts(range(len(chunk)),
                                   rec._dispatch(width, chunk, batch))
                        .values())
        return out

    assert read(same, 32) == read(same, 8) == read(same[::-1], 32)[::-1]

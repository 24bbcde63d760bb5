"""Warm-pipeline OCR service: JSONL requests on stdin, JSONL results on
stdout. Counterpart of ocr_inference_tpu/cli/serve_cli.py (``bocr-serve``):

    python -m ocr_inference_tpu_torch.cli.serve_cli --model DIR [options]

Production serving surface with no reference equivalent (the reference's
only entry points are one-shot CLIs and notebooks, cli.py:19-162): the
pipeline loads once and requests stream through the same batched
VolumeRunner path the bulk CLI uses, so a steady request stream gets
cross-page line batching and detect/geometry overlap, not page-at-a-time
latency.

Protocol (one JSON object per line):
  request:  {"image": "/path/page.png"}            # or {"images": [...]}
  response: {"image": ..., "status": "success", "angle": 0.3,
             "lines": [{"text": ..., "bbox": [x, y, w, h]}, ...]}
  errors:   {"image": ..., "status": "failed", "error": "..."}

A blank line or EOF ends the session. Example:
  printf '%s\\n' '{"image": "page.png"}' | \\
      python -m ocr_inference_tpu_torch.cli.serve_cli --model Models/Woodblock

Differences from the JAX service:

- ``--device`` (default ``cuda``), ``--dtype`` (default ``bfloat16``) and
  ``--seed`` (of the weights ``--allow-random-weights`` makes); without a
  card the default device raises;
- pages are read with io/images.py ``read_image`` (PNG, JPEG, TIFF, JPEG
  2000, BMP, PNM and PAM, as cv2.imread reads them): a request for a
  format or variant it does not decode (WebP, GIF, a JPEG 2000 TIFF, ...)
  is answered with a ``failed`` line that names it;
- a CUDA error ends the session: its last line is a ``failed`` object
  naming the fault (``"fatal": true``) and the process exits 1. CUDA
  errors are sticky, so no later request could be served;
- the JAX service's persistent compilation cache has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ocr_inference_tpu_torch.cli.cli import DTYPES
from ocr_inference_tpu_torch.core.assets import (
    import_local_model,
    read_layout_model_config,
    read_line_model_config,
)
from ocr_inference_tpu_torch.core.data import Encoding, OpStatus
from ocr_inference_tpu_torch.device import is_device_fault
from ocr_inference_tpu_torch.io.images import read_image
from ocr_inference_tpu_torch.pipeline.builder import (
    build_pipeline,
    default_layout_config,
    default_line_config,
)
from ocr_inference_tpu_torch.pipeline.volume import VolumeRunner


class _LineReader:
    """Line reader over stdin supporting a zero-timeout drain.

    Buffers os.read() chunks from the raw fd itself (never the C stdio
    layer), so select() readability plus this buffer are the only state —
    a partial line whose newline hasn't arrived yet can never block the
    drain, and queued lines are never hidden in a read-ahead buffer.
    Falls back to sys.stdin.readline (blocking reads only, no drain) when
    stdin has no usable fileno (tests with StringIO, some pipes).
    """

    def __init__(self, fd: int | None = None):
        """``fd`` overrides stdin — the serve benchmark drives the real
        loop through an os.pipe with Poisson-timed request arrivals,
        exercising the same select()-based drain as production."""
        self._buf = b""
        self._eof = False
        if fd is not None:
            self._fd = fd
            return
        try:
            self._fd = sys.stdin.fileno()
        except (OSError, ValueError, AttributeError):
            self._fd = None

    def _pop_line(self):
        nl = self._buf.find(b"\n")
        if nl < 0:
            return None
        line, self._buf = self._buf[:nl], self._buf[nl + 1:]
        return line.decode("utf-8", "replace").strip()

    def next_line(self):
        """Blocking read of the next complete line; None on EOF,
        "" on a blank line (protocol session end)."""
        if self._fd is None:
            raw = sys.stdin.readline()
            return None if not raw else raw.strip()
        while True:
            line = self._pop_line()
            if line is not None:
                return line
            if self._eof:
                if self._buf:
                    tail, self._buf = self._buf, b""
                    return tail.decode("utf-8", "replace").strip()
                return None
            chunk = os.read(self._fd, 65536)
            if not chunk:
                self._eof = True
            self._buf += chunk

    def drain_ready(self):
        """Dynamic batching: all complete request lines ALREADY queued on
        stdin (zero timeout — never waits, even on a half-written line).
        Returns (lines, session_end); a blank line inside the drain marks
        the session end per the protocol, served after this batch."""
        lines: list[str] = []
        if self._fd is None:
            return lines, False
        import select

        try:
            while not self._eof and select.select([self._fd], [], [], 0)[0]:
                chunk = os.read(self._fd, 65536)
                if not chunk:
                    self._eof = True
                    break
                self._buf += chunk
        except (OSError, ValueError):  # non-selectable stdin
            return lines, False
        while True:
            line = self._pop_line()
            if line is None:
                break
            if line == "":
                return lines, True
            lines.append(line)
        return lines, self._eof and not self._buf


def _parse_request(raw: str, emit_error):
    """One request line -> list of paths, or None after emitting the
    error response."""
    try:
        req = json.loads(raw)
    except json.JSONDecodeError as e:
        emit_error({"status": "failed", "error": f"bad request: {e}"})
        return None
    if not isinstance(req, dict):
        emit_error({"status": "failed",
                    "error": "request must be a JSON object"})
        return None
    many = req.get("images")
    paths = many if isinstance(many, list) else [req.get("image")]
    paths = [p for p in paths if isinstance(p, str) and p]
    if not paths:
        emit_error({"status": "failed",
                    "error": "no 'image' (string) or 'images' "
                             "(list of strings) in request"})
    return paths or None


def serve_loop(runner, reader: _LineReader, load, emit, emit_error, *,
               encoding, use_tps: bool = False, k_factor: float = 2.5,
               bbox_tolerance: float = 4.0,
               max_queue: int | None = 32) -> None:
    """The serving loop proper: each iteration serves one burst — the
    blocking read plus whatever is already queued (dynamic batching); a
    single-image request with an idle stream answers immediately, a burst
    flows through the batched volume path. The engines stay warm across
    requests. A blank line or EOF — including one arriving mid-drain —
    ends the session after its batch is served.

    ``max_queue`` is the overload control: an open-loop stream past
    saturation would grow the drain burst, and so the latency, without
    bound. Each burst admits at most max_queue pages; the rest are SHED
    immediately with a 429-style JSONL error, so the latency of accepted
    requests stays bounded by one burst's service time instead of the
    whole backlog's. None disables shedding.

    Factored out of main() so a benchmark can drive the identical loop
    over an os.pipe request stream."""
    session_end = False
    while not session_end:
        raw = reader.next_line()
        if not raw:
            break
        extra, session_end = reader.drain_ready()
        batch_paths: list[str] = []
        for line in [raw, *extra]:
            paths = _parse_request(line, emit_error)
            if paths:
                batch_paths.extend(paths)
        if not batch_paths:
            continue
        if max_queue is not None and len(batch_paths) > max_queue:
            for p in batch_paths[max_queue:]:
                emit_error({
                    "image": p,
                    "status": "shed",
                    "code": 429,
                    "error": (
                        "server overloaded: burst queue full "
                        f"({len(batch_paths)} queued > max_queue="
                        f"{max_queue}); retry later"
                    ),
                })
            batch_paths = batch_paths[:max_queue]
        runner.run(
            [(p, load(p)) for p in batch_paths],
            target_encoding=encoding,
            use_tps=use_tps,
            k_factor=k_factor,
            bbox_tolerance=bbox_tolerance,
            on_page_done=emit,
        )


def _record_to_json(rec) -> dict:
    if rec.status != OpStatus.SUCCESS:
        return {"image": rec.name, "status": "failed", "error": rec.error}
    lines = []
    for line, ocr_line in zip(rec.lines, rec.ocr_lines):
        x, y, w, h = line.bbox.x, line.bbox.y, line.bbox.w, line.bbox.h
        lines.append({"text": ocr_line.text, "bbox": [x, y, w, h]})
    return {
        "image": rec.name,
        "status": "success",
        "angle": rec.angle,
        "lines": lines,
    }


def load_page(path: str):
    """A loader for VolumeRunner: the page as RGB, None when it cannot be
    read; a format or variant read_image does not decode raises, naming
    it, and fails that page."""
    return lambda: read_image(path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Serve OCR over stdin/stdout JSONL with a warm pipeline"
    )
    parser.add_argument("--model", required=True, help="OCR model directory")
    parser.add_argument("--line-model", help="Line/layout model config JSON")
    parser.add_argument("--line-mode", choices=["line", "layout"],
                        default="line")
    parser.add_argument("--encoding", choices=["unicode", "wylie"],
                        default="unicode")
    parser.add_argument("--dewarp", action="store_true")
    parser.add_argument("--k-factor", type=float, default=2.5)
    parser.add_argument("--bbox-tolerance", type=float, default=4.0)
    parser.add_argument("--window-pages", type=int, default=4,
                        help="Pages batched per recognition window (smaller "
                             "= lower latency, larger = higher throughput)")
    parser.add_argument("--max-queue", type=int, default=32,
                        help="Overload control: max pages admitted per "
                             "burst; overflow is shed immediately with a "
                             "429-style JSONL error (0 disables shedding)")
    parser.add_argument("--allow-random-weights", action="store_true")
    parser.add_argument("--seed", type=int, default=0,
                        help="Seed of the weights --allow-random-weights "
                             "makes")
    parser.add_argument("--device", default="cuda",
                        help="Device to run on: 'cuda' (default) or 'cpu'")
    parser.add_argument("--dtype", choices=list(DTYPES), default="bfloat16",
                        help="Compute precision of both models")
    args = parser.parse_args(argv)

    model = import_local_model(args.model)
    if model is None:
        print(json.dumps({"status": "failed",
                          "error": f"not a model dir: {args.model}"}))
        return 1
    if args.line_model:
        reader = (
            read_line_model_config
            if args.line_mode == "line"
            else read_layout_model_config
        )
        line_cfg = reader(args.line_model)
    elif args.line_mode == "layout":
        line_cfg = default_layout_config()
    else:
        line_cfg = default_line_config()
    pipeline = build_pipeline(
        model.config, line_cfg, dtype=DTYPES[args.dtype], device=args.device,
        allow_random=args.allow_random_weights, seed=args.seed,
    )
    runner = VolumeRunner(pipeline, window_pages=max(1, args.window_pages))
    encoding = (
        Encoding.WYLIE if args.encoding == "wylie" else Encoding.UNICODE
    )

    def emit(rec):
        print(json.dumps(_record_to_json(rec), ensure_ascii=False),
              flush=True)

    def emit_error(obj: dict):
        print(json.dumps(obj), flush=True)

    try:
        serve_loop(
            runner, _LineReader(), load_page, emit, emit_error,
            encoding=encoding,
            use_tps=args.dewarp,
            k_factor=args.k_factor,
            bbox_tolerance=args.bbox_tolerance,
            max_queue=args.max_queue if args.max_queue > 0 else None,
        )
    except Exception as e:
        if not is_device_fault(e):
            raise
        emit_error({"status": "failed", "fatal": True,
                    "error": f"device fault, session ended: "
                             f"{type(e).__name__}: {e}"})
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device engines: tiled line segmentation and bucketed line recognition.

Counterpart of ocr_inference_tpu/pipeline/engines.py (reference:
BDRC/inference.py:121-429), without jit caches or mesh.
Binarizing runs on the card through the hand-written kernel
(ops/kernels.py) in both engines — the JAX default path does it on the
host with cv2 and uploads packed bits; the kernel gives the same bytes.

- ``SegmentationEngine.predict_async``: page -> tiles -> binarize kernel
  -> model in chunks rounded to 8 -> line mode: sigmoid > 0.9, stitch,
  crop, resize, ``>= 1.0``, horizontal opening; layout mode: float32
  softmax over the classes > 0.8, the same stitch/crop/resize of the
  (H, W, C) stack -> bit-packed mask, all queued on the card; the
  resolver waits for the packed mask's copy to the host alone
  (engines.py:340-380, :440-466, :510-562). ``predict_many_async`` runs
  several pages' tiles as one stream (engines.py:569-636).
- ``RecognitionEngine.run_batch``: host canvas pad per width bucket,
  batches rounded to {1, 2, 4, 8, 16, 24, ...}, line binarize kernel,
  the recognizer, greedy CTC on the card (engines.py:861-923).
- ``RecognitionEngine`` streaming (``stream_add`` / ``stream_run``): the
  cross-window carry the volume runner feeds, batches of ``quantum`` and
  power-of-two tails only (engines.py:1076-1182).
- ``RecognitionEngine`` eval mode (``run_batch_beams``, ``calibrate_lm``):
  the same forward up to the recognizer, whose float32 logits of the real rows
  come back to the host, where the CTC prefix beam search runs, with or
  without shallow fusion of the n-gram LM (engines.py:924-1060).

Copies between host and card never wait for other work (device.py
``upload``, ``PendingHost``). The recognizer runs on its own CUDA stream,
so a volume's recognition (flush thread) and detection (main thread)
overlap on the card.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ocr_inference_tpu_torch.core.config import (
    LAYOUT_CLASS_THRESHOLD,
    LINE_CLASS_THRESHOLD,
)
from ocr_inference_tpu_torch.core.data import (
    BatchConfig,
    KenLMConfig,
    OCRModelConfig,
)
from ocr_inference_tpu_torch.device import PendingHost, host_buffer, upload
from ocr_inference_tpu_torch.decode.decoder import CTCDecoder
from ocr_inference_tpu_torch.decode.ctc import (
    greedy_decode_packed,
    ids_to_tokens,
    unpack_greedy_host,
)
from ocr_inference_tpu_torch.ops import kernels, packing, tiling
from ocr_inference_tpu_torch.ops.imaging import resize_bilinear, rgb_to_gray


class SegmentationEngine:
    """Page -> class mask(s), queued on the card. ``mode="line"``: sigmoid,
    threshold 0.9, one (H, W) mask (reference: inference.py:166-183);
    ``mode="layout"``: softmax over the classes, threshold 0.8, an
    (H, W, C) stack of per-class masks (reference: inference.py:186-276;
    engines.py:374-380, :557-560). Masks are uint8 0/255."""

    TILE_CHUNK = 32  # most tiles per chunk (engines.py:140)
    # In layout mode every model call runs exactly this many tiles of a
    # chunk. cuDNN picks its algorithm by the batch size, and in bf16
    # another algorithm moves some DeepLabV3+ mask pixels across the
    # threshold (on the H100: up to 1.6e-3 of a class's pixels between
    # calls of 24 and of 32 tiles), so a page's masks would depend on the
    # pages that share its tile stream in predict_many_async. Line mode
    # keeps one call a chunk.
    LAYOUT_MODEL_BATCH = 8

    def __init__(
        self,
        model: torch.nn.Module,
        device: torch.device,
        mode: str = "line",
        patch_size: int = 512,
        classes: Optional[list[str]] = None,
        open_width_frac: float = 0.0,
    ):
        if mode not in ("line", "layout"):
            raise ValueError(f"mode must be 'line' or 'layout', got {mode!r}")
        self.model = model
        self.device = device
        self.mode = mode
        self.patch_size = patch_size
        self.classes = classes or ["line"]
        # Horizontal opening erasing components narrower than this fraction
        # of the page width: the builder turns it on for stem-2 detectors,
        # whose thin tile-edge artifacts pass the contour filter
        # (engines.py:174-186, builder.py:110). Line mode only.
        self.open_width_frac = open_width_frac

    def _threshold(self, class_threshold: Optional[float]) -> float:
        if class_threshold is not None:
            return class_threshold
        return (LINE_CLASS_THRESHOLD if self.mode == "line"
                else LAYOUT_CLASS_THRESHOLD)

    def _run_tiles(self, bw: torch.Tensor) -> torch.Tensor:
        """Forward binarized (N, p, p) uint8 tiles in chunks: the tile count
        rounded up to a multiple of 8, at most TILE_CHUNK tiles a chunk,
        zero tiles after the real ones; one model call a chunk, or in
        layout mode calls of LAYOUT_MODEL_BATCH, the last chunk padded to
        a whole call only. The model sees each tile as three equal
        channels in {0.0, 1.0}."""
        n = bw.shape[0]
        chunk = min(-(-n // 8) * 8, self.TILE_CHUNK)
        per_call = self.LAYOUT_MODEL_BATCH
        outs = []
        for start in range(0, n, chunk):
            block = bw[start: start + chunk]
            real = block.shape[0]
            size = (chunk if self.mode == "line"
                    else -(-real // per_call) * per_call)
            if real < size:
                block = F.pad(block, (0, 0, 0, 0, 0, size - real))
            x = (block.to(torch.float32) / 255.0)[:, None].expand(-1, 3, -1, -1)
            if self.mode == "layout":
                y = torch.cat([self.model(c) for c in x.split(per_call)])
            else:
                y = self.model(x)
            outs.append(y[:real])
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def _open_horizontal(mask: torch.Tensor, k: int) -> torch.Tensor:
        """Binary opening with a 1 x k element: erosion (zero padding, so
        page-edge blobs erode too) then dilation (engines.py:322-338)."""
        x = mask.to(torch.float32)[None]
        lo, hi = k // 2, k - 1 - k // 2
        er = -F.max_pool1d(-F.pad(x, (lo, hi)), k, stride=1)
        di = F.max_pool1d(F.pad(er, (hi, lo)), k, stride=1)
        return di[0] > 0.5

    def _queue_tiles(self, image: np.ndarray):
        """Upload a page, resize and pad it per its plan, cut it into tiles
        and binarize each with the tile kernel (the reference binarizes per
        tile, inference.py:132-139) -> (plan, (N, p, p) uint8 tiles)."""
        h, w = image.shape[:2]
        plan = tiling.plan_page(h, w, self.patch_size)
        page = upload(image, self.device)
        tiles = tiling.tile_page(tiling.preprocess_page(page, plan),
                                 self.patch_size)
        return plan, kernels.binarize_tiles(tiles)

    def _post(self, logits: torch.Tensor, plan: tiling.PagePlan,
              threshold: float) -> PendingHost:
        """A page's logits tiles -> its bit-packed mask, copied to the host
        (engines.py:357-380): threshold, stitch, crop, resize to the page,
        ``>= 1.0`` (the reference truncates before *255, so only 1.0
        survives), pack along W. Layout masks are packed as (C, H, W)."""
        if self.mode == "line":
            pred = (torch.sigmoid(logits[:, 0]) > threshold).float()
        else:
            probs = torch.softmax(logits.float(), dim=1)
            pred = (probs > threshold).float().permute(0, 2, 3, 1)
        merged = tiling.crop_padding(
            tiling.stitch_tiles(pred, plan.y_steps), plan.pad_x, plan.pad_y
        )
        m = resize_bilinear(merged, plan.orig_h, plan.orig_w) >= 1.0
        if self.mode == "layout":
            m = m.permute(2, 0, 1)
        elif self.open_width_frac > 0:
            k = max(int(plan.orig_w * self.open_width_frac) | 1, 3)
            m = self._open_horizontal(m, k)
        return PendingHost(packing.pack_mask(m))

    def _resolver(self, packed: PendingHost, w: int):
        """Zero-arg resolver: waits for the packed mask's copy alone ->
        (H, W) or, in layout mode, (H, W, C) uint8 mask, values 0/255."""

        def resolve() -> np.ndarray:
            bits = packing.unpack_mask(packed.get(), w)
            if self.mode == "layout":
                bits = np.ascontiguousarray(bits.transpose(1, 2, 0))
            return bits * np.uint8(255)

        return resolve

    @staticmethod
    def _check_page(image: np.ndarray) -> None:
        if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
            raise ValueError(
                f"expected an (H, W, 3) uint8 page, got {image.shape} "
                f"{image.dtype}")

    @torch.inference_mode()
    def predict_async(self, image: np.ndarray,
                      class_threshold: Optional[float] = None):
        """Queue a page's detection on the card; returns a zero-arg
        resolver giving its mask.

        Everything from the upload to the bit-packed mask's copy to the
        host is queued here, with no wait on the card in between; the
        resolver waits only for that copy. A page of the wrong shape or
        type raises here, before anything is queued."""
        self._check_page(image)
        plan, bw = self._queue_tiles(image)
        packed = self._post(self._run_tiles(bw), plan,
                            self._threshold(class_threshold))
        return self._resolver(packed, image.shape[1])

    def predict(self, image: np.ndarray,
                class_threshold: Optional[float] = None) -> np.ndarray:
        """(H, W, 3) uint8 RGB page -> uint8 mask, values 0/255: (H, W) in
        line mode, (H, W, C) in layout mode."""
        return self.predict_async(image, class_threshold)()

    @torch.inference_mode()
    def predict_many_async(self, images: Sequence[np.ndarray],
                           class_threshold: Optional[float] = None) -> list:
        """Many pages, one tile stream (engines.py:569-613): every page's
        tiles join one stack, so model calls fill across page boundaries
        (pages may differ in size); returns one resolver a page. Every
        page is checked before anything is queued."""
        if not images:
            return []
        for image in images:
            self._check_page(image)
        threshold = self._threshold(class_threshold)
        queued = [self._queue_tiles(image) for image in images]
        stack = [bw for _, bw in queued]
        logits = self._run_tiles(stack[0] if len(stack) == 1
                                 else torch.cat(stack))
        resolvers, start = [], 0
        for image, (plan, _) in zip(images, queued):
            page_logits = logits[start: start + plan.n_tiles]
            start += plan.n_tiles
            resolvers.append(self._resolver(
                self._post(page_logits, plan, threshold), image.shape[1]))
        return resolvers

    def predict_many_batched(self, items, batch_size: int = 4,
                             class_threshold: Optional[float] = None):
        """Generator over (key, image) pairs yielding (key, image, mask),
        pages grouped into ``batch_size`` calls of predict_many_async
        (engines.py:615-636)."""
        batch: list = []

        def flush():
            resolvers = self.predict_many_async(
                [img for _, img in batch], class_threshold=class_threshold)
            for (key, img), resolve in zip(batch, resolvers):
                yield key, img, resolve()
            batch.clear()

        for key, image in items:
            batch.append((key, image))
            if len(batch) >= max(1, batch_size):
                yield from flush()
        if batch:
            yield from flush()


class StreamState:
    """Cross-call carry for RecognitionEngine's streaming API: prepared
    line canvases grouped by width bucket, each tagged with the caller's
    token. Owned by one consumer thread (VolumeRunner's flush worker)."""

    def __init__(self):
        self.by_width: dict[int, list] = {}


class RecognitionEngine:
    """Batched line recognizer (reference: OCRInference,
    inference.py:279-429): canvases padded into width buckets on the host,
    then per (bucket, batch): line binarize kernel -> [-1, 1] -> the
    recognizer (any architecture of ``build_recognizer``) -> greedy CTC on
    the card, or in eval mode the logits back to the host for the beam
    search."""

    # streaming batches: full batches of this many lines, power-of-two
    # tails (engines.py:1076-1094)
    STREAM_QUANTUM = 32
    # Every recognizer call runs exactly this many canvases, zero rows
    # after the real ones, whatever the architecture. cuDNN picks its
    # algorithm by the batch size, for convolutions and RNNs alike, and in
    # bf16 another algorithm changes some lines' texts (probe_volume.py:
    # 5 of 30 lines between one call of 32 and calls of 8), so a line's text
    # would depend on the lines that share its batch. With one call size a
    # volume reads each page as run_ocr does.
    MODEL_BATCH = 8

    def __init__(
        self,
        model: torch.nn.Module,
        config: OCRModelConfig,
        device: torch.device,
        batch_cfg: BatchConfig | None = None,
        kenlm_config: KenLMConfig | None = None,
    ):
        self.model = model
        self.config = config
        self.device = device
        self.batch_cfg = batch_cfg or BatchConfig()
        self.charset = list(config.charset)
        self.ctc_decoder = CTCDecoder(config.charset, config.add_blank)
        self.ctc_decoder_lm = (
            CTCDecoder(config.charset, config.add_blank, kenlm_config)
            if kenlm_config is not None else None
        )
        # Shallow fusion ships guarded: calibrate_lm() clears this when the
        # LM does not beat the plain beam on labeled strips, and every later
        # run_batch_beams(use_lm=True) is then a plain beam
        # (engines.py:718-722).
        self.lm_fusion_enabled = True
        # (bucket_width, real_lines, padded_batch) -> calls, over every
        # forward run_batch and the streaming path make (engines.py:733)
        self.occupancy: dict[tuple[int, int, int], int] = {}
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _buckets(self) -> tuple[int, ...]:
        w = self.config.input_width
        return tuple(b for b in self.batch_cfg.width_buckets if b < w) + (w,)

    def prepare_canvas(self, line_image: np.ndarray,
                       pre_pad: bool = False) -> np.ndarray:
        """Strip -> (input_height, bucket) uint8 gray canvas, after the
        optional white squares of ``pre_pad``. RGB strips are padded in 3
        channels and then converted (engines.py:746-775); gray strips are
        padded directly (RGB2GRAY of a replicated gray is the identity)."""
        img = line_image
        if img.ndim == 3 and img.shape[2] == 1:
            img = img[..., 0]
        if pre_pad:
            img = tiling.pre_pad_line(img)
        height = self.config.input_height
        bucket = tiling.bucket_for_width(img.shape[1], img.shape[0], height,
                                         self._buckets())
        canvas = tiling.pad_ocr_line(
            torch.from_numpy(np.ascontiguousarray(img)), bucket, height)
        if canvas.ndim == 3:
            canvas = rgb_to_gray(canvas)
        return canvas.numpy()

    def _rows(self, padded_b: int) -> int:
        """Rows a batch of ``padded_b`` runs: a multiple of MODEL_BATCH."""
        return -(-padded_b // self.MODEL_BATCH) * self.MODEL_BATCH

    def _logits(self, host: torch.Tensor) -> torch.Tensor:
        """Queue one (B, H, W) uint8 batch, B a multiple of MODEL_BATCH:
        upload, line binarize kernel, the recognizer in calls of MODEL_BATCH ->
        (B, T, V) float32 logits on the device."""
        gray = host.to(self.device, non_blocking=True)
        bw = kernels.binarize_lines(gray)
        x = bw.to(torch.float32) / 127.5 - 1.0
        return torch.cat([self.model(c) for c in x.split(self.MODEL_BATCH)])

    def _forward(self, host: torch.Tensor) -> PendingHost:
        """``_logits``, greedy CTC, and the packed result's copy to the
        host."""
        return PendingHost(greedy_decode_packed(self._logits(host)))

    def _dispatch(self, width: int, canvases: list[np.ndarray],
                  padded_b: int, want_logits: bool = False) -> PendingHost:
        """One forward of a (padded_b, width) batch, zero rows after the
        real ones; counted in ``occupancy``. With ``want_logits`` the
        float32 logits of the real rows come back instead of the packed
        greedy ids (engines.py:789-815, ``logits[: len(idxs)]``)."""
        key = (width, len(canvases), padded_b)
        self.occupancy[key] = self.occupancy.get(key, 0) + 1
        host = host_buffer((self._rows(padded_b), self.config.input_height,
                            width), self.device)
        rows = host.numpy()
        for i, canvas in enumerate(canvases):
            rows[i] = canvas
        rows[len(canvases):] = 0
        if want_logits:
            return PendingHost(self._logits(host)[: len(canvases)])
        return self._forward(host)

    def _texts(self, tokens, pending: PendingHost) -> dict:
        """Wait for one batch's packed ids -> {token: text}."""
        ids, lengths, _ = unpack_greedy_host(pending.get())
        return {
            token: "".join(ids_to_tokens(ids[row], int(lengths[row]),
                                         self.charset, self.config.add_blank))
            for row, token in enumerate(tokens)
        }

    def _batches(self, prepared: list[tuple[int, np.ndarray]]):
        """Group canvases by bucket width and yield (width, padded batch,
        idxs, canvases) with the batch rounded up to {1, 2, 4, 8, 16, 24,
        32, ...} (engines.py:871-893)."""
        by_width: dict[int, list[tuple[int, np.ndarray]]] = {}
        for idx, canvas in prepared:
            by_width.setdefault(canvas.shape[1], []).append((idx, canvas))
        bmax = self.batch_cfg.max_lines_per_batch
        for width, items in sorted(by_width.items()):
            for start in range(0, len(items), bmax):
                chunk = items[start: start + bmax]
                n = len(chunk)
                if n <= 8:
                    b = 1
                    while b < n:
                        b *= 2
                else:
                    b = -(-n // 8) * 8
                yield (width, min(b, bmax), [idx for idx, _ in chunk],
                       [canvas for _, canvas in chunk])

    def _prepare_batches(self, line_images: Sequence[np.ndarray],
                         pre_pad: bool) -> list[tuple]:
        """The non-empty strips' canvases grouped into the batches of
        ``_batches``, in the order they are queued."""
        prepared = [
            (i, self.prepare_canvas(img, pre_pad))
            for i, img in enumerate(line_images)
            if img.shape[0] > 0 and img.shape[1] > 0
        ]
        return list(self._batches(prepared))

    @torch.inference_mode()
    def run_batch(self, line_images: Sequence[np.ndarray],
                  pre_pad: bool = False) -> list[str]:
        """Recognize many lines; returns texts in input order. Every batch
        is queued before the first result is read."""
        with self._on_stream():
            pending = [(idxs, self._dispatch(width, canvases, b))
                       for width, b, idxs, canvases
                       in self._prepare_batches(line_images, pre_pad)]
        texts: dict[int, str] = {}
        for idxs, p in pending:
            texts.update(self._texts(idxs, p))
        return [texts.get(i, "") for i in range(len(line_images))]

    # -- eval mode: logits to the host, beam search there --

    def _queue_logits(self, batches: list[tuple]
                      ) -> list[tuple[list[int], PendingHost]]:
        """Queue the logits forward of every batch of ``_prepare_batches``;
        returns (line indices, pending (n, T, V) float32 logits) per
        batch."""
        with self._on_stream():
            return [(idxs, self._dispatch(width, canvases, b,
                                          want_logits=True))
                    for width, b, idxs, canvases in batches]

    @torch.inference_mode()
    def line_logits(self, line_images: Sequence[np.ndarray],
                    pre_pad: bool = False) -> dict[int, np.ndarray]:
        """{line index: its (T, V) float32 logits on the host} for every
        non-empty line."""
        out: dict[int, np.ndarray] = {}
        for idxs, p in self._queue_logits(
                self._prepare_batches(line_images, pre_pad)):
            logits = p.get()
            for row, idx in enumerate(idxs):
                out[idx] = logits[row]
        return out

    @torch.inference_mode()
    def run_batch_beams(
        self,
        line_images: Sequence[np.ndarray],
        pre_pad: bool = False,
        use_lm: bool = False,
        top_k: int = 10,
    ):
        """Eval mode: per-line beam hypotheses in input order (reference
        run_beam_code, inference.py:400-414; engines.py:924-953). The
        forwards of all buckets are queued first; each batch is then
        decoded on the host as its logits arrive. ``use_lm`` fuses the LM
        only while ``lm_fusion_enabled``."""
        use_lm = use_lm and self.lm_fusion_enabled
        decoder = (
            self.ctc_decoder_lm
            if (use_lm and self.ctc_decoder_lm is not None)
            else self.ctc_decoder
        )
        beams_by_idx: dict[int, list] = {}
        for idxs, p in self._queue_logits(
                self._prepare_batches(line_images, pre_pad)):
            batch_beams = decoder.ctc_beam_decode_batch(
                p.get(), use_lm=use_lm, top_k=top_k
            )
            for row, idx in enumerate(idxs):
                beams_by_idx[idx] = batch_beams[row]
        return [beams_by_idx.get(i, []) for i in range(len(line_images))]

    def run(self, line_image: np.ndarray, pre_pad: bool = False,
            use_lm: bool = False) -> str:
        """One line's greedy text (reference: inference.py:416-429;
        engines.py:1184-1187). ``use_lm`` is taken and ignored, as the JAX
        engine does."""
        return self.run_batch([line_image], pre_pad=pre_pad)[0]

    def run_beam_code(self, line_image: np.ndarray, pre_pad: bool = True):
        """One line's beams (reference: inference.py:400-414)."""
        return self.run_batch_beams([line_image], pre_pad=pre_pad)[0]

    def calibrate_lm(
        self,
        line_images: Sequence[np.ndarray],
        refs: Sequence[str],
        alphas: Sequence[float] = (0.2, 0.4, 0.7, 1.0),
        betas: Sequence[float] = (-0.5, 0.0, 0.5),
        pre_pad: bool = False,
    ) -> dict:
        """Tune shallow-fusion (alpha, beta) on labeled strips; turn fusion
        off when no grid point beats the plain beam (engines.py:955-1060).

        The forward runs once; each grid point re-decodes the cached logits
        of the tuning half (the even lines), and the winner must also beat
        the plain beam on the held-out odd lines, or ``lm_fusion_enabled``
        clears. ``refs`` use the pipeline's text convention ("§" already a
        space). Returns the JAX report: the tuning half's plain-beam CER,
        the grid [alpha, beta, CER] rounded to 5 digits, the line count,
        ``enabled`` and, when a point won the tuning half, the holdout
        CERs, and when it is kept, ``alpha``, ``beta`` and its CER."""
        from ocr_inference_tpu_torch.eval.cer import cer

        dec = self.ctc_decoder_lm
        if dec is None or not dec.has_lm:
            self.lm_fusion_enabled = False
            return {"enabled": False, "reason": "no LM loaded"}
        logits_by_idx = self.line_logits(line_images, pre_pad)
        order = sorted(logits_by_idx)
        tune = order[0::2]
        hold = order[1::2] or tune  # degenerate tiny samples: no holdout

        def decode_all(subset, use_lm: bool) -> list[str]:
            texts = []
            for i in subset:
                beams = dec.ctc_beam_decode(
                    logits_by_idx[i], use_lm=use_lm, top_k=1
                )
                texts.append(
                    beams[0].text.strip().replace("§", " ") if beams else ""
                )
            return texts

        def score(subset, use_lm: bool) -> float:
            return cer(decode_all(subset, use_lm), [refs[i] for i in subset])

        base_tune = score(tune, False)
        best_a = best_b = None
        best = base_tune
        grid = []
        for a in alphas:
            for b_ in betas:
                dec.lm_alpha, dec.lm_beta = a, b_
                c = score(tune, True)
                grid.append([a, b_, round(c, 5)])
                if c < best:
                    best_a, best_b, best = a, b_, c
        report = {
            "cer_beam": round(base_tune, 5),
            "grid": grid,
            "lines": len(order),
        }
        if best_a is not None:
            # holdout gate: the chosen point must not lose on unseen lines
            dec.lm_alpha, dec.lm_beta = best_a, best_b
            base_hold = score(hold, False)
            lm_hold = score(hold, True)
            report.update(
                cer_beam_holdout=round(base_hold, 5),
                cer_beam_lm_holdout=round(lm_hold, 5),
            )
            if lm_hold > base_hold:
                best_a = None
        if best_a is None:
            self.lm_fusion_enabled = False
            print(
                "LM fusion auto-disabled: no (alpha, beta) beat the plain "
                f"beam on both calibration halves (tune CER {base_tune:.4f})",
                file=sys.stderr,
            )
            report.update(enabled=False)
        else:
            self.lm_fusion_enabled = True
            dec.lm_alpha, dec.lm_beta = best_a, best_b
            report.update(
                enabled=True, alpha=best_a, beta=best_b,
                cer_beam_lm=round(best, 5),
            )
        return report

    # -- streaming recognition (cross-window carry) --

    def stream_state(self) -> StreamState:
        """Fresh carry state for one streaming run (one volume)."""
        return StreamState()

    def stream_add(self, state: StreamState, token, line_image: np.ndarray,
                   pre_pad: bool = False) -> None:
        """Prepare one line into its width bucket under ``token`` (any
        hashable caller id); it resolves in a later stream_run."""
        canvas = self.prepare_canvas(line_image, pre_pad)
        state.by_width.setdefault(canvas.shape[1], []).append((token, canvas))

    def _stream_chunk(self, width: int, chunk, padded_b: int):
        """Queue one forward of (token, canvas) pairs at the fixed
        (padded_b, width) shape -> (tokens, pending result)."""
        return ([token for token, _ in chunk],
                self._dispatch(width, [c for _, c in chunk], padded_b))

    def _stream_quantum(self, quantum: Optional[int]) -> int:
        q = quantum or self.STREAM_QUANTUM
        return min(q, self.batch_cfg.max_lines_per_batch)

    @torch.inference_mode()
    def stream_run(
        self,
        state: StreamState,
        final: bool = False,
        force_tokens=(),
        quantum: Optional[int] = None,
    ) -> dict:
        """Recognize what can run at full occupancy; returns token->text.

        Buckets flush in chunks of ``quantum``; remainders stay carried
        unless ``final`` or the bucket holds a token in ``force_tokens``
        (the caller's page-holding bound), in which case the remainder runs
        at the next power-of-two shape."""
        force = set(force_tokens)
        q = self._stream_quantum(quantum)
        pending = []
        with self._on_stream():
            for width in sorted(state.by_width):
                lst = state.by_width[width]
                flush_all = final or (
                    bool(force) and any(t in force for t, _ in lst)
                )
                while len(lst) >= q:
                    chunk = lst[:q]
                    del lst[:q]
                    pending.append(self._stream_chunk(width, chunk, q))
                if flush_all and lst:
                    chunk = lst[:]
                    lst.clear()
                    b = 1
                    while b < len(chunk):
                        b *= 2
                    pending.append(self._stream_chunk(width, chunk, min(b, q)))
        for w in [w for w, lst in state.by_width.items() if not lst]:
            del state.by_width[w]
        out: dict = {}
        for tokens, p in pending:
            out.update(self._texts(tokens, p))
        return out

    @torch.inference_mode()
    def warm_shapes(self, widths=None, quantum: Optional[int] = None) -> int:
        """Run every forward shape the streaming path can emit — {1, 2, 4,
        ..., quantum} per bucket — once on zeros, so that a timed volume
        starts with cuDNN's plans and the caching allocators' blocks for
        all of them (engines.py:1143-1176). Returns the number of shapes.
        Not counted in ``occupancy``."""
        if widths is None:
            widths = self._buckets()
        q = self._stream_quantum(quantum)
        batches = {q}
        b = 1
        while b < q:
            batches.add(b)
            b *= 2
        with self._on_stream():
            pending = [
                self._forward(host_buffer(
                    (self._rows(bb), self.config.input_height, width),
                    self.device).zero_())
                for width in widths for bb in sorted(batches)
            ]
        for p in pending:
            p.get()
        return len(pending)

"""Device engines: tiled line segmentation and bucketed line recognition.

Counterpart of ocr_inference_tpu/pipeline/engines.py (reference:
BDRC/inference.py:121-429), without jit caches, mesh, beams or the LM.
Binarizing runs on the card through the hand-written kernel
(ops/kernels.py) in both engines — the JAX default path does it on the
host with cv2 and uploads packed bits; the kernel gives the same bytes.

- ``SegmentationEngine.predict_async`` (line mode): page -> tiles ->
  binarize kernel -> UNet in chunks rounded to 8 -> sigmoid > 0.9, stitch,
  crop, resize, ``>= 1.0``, horizontal opening -> bit-packed mask, all
  queued on the card; the resolver waits for the packed mask's copy to
  the host alone (engines.py:340-380, :440-466, :510-562).
- ``RecognitionEngine.run_batch``: host canvas pad per width bucket,
  batches rounded to {1, 2, 4, 8, 16, 24, ...}, line binarize kernel,
  Easter2, greedy CTC on the card (engines.py:861-923).
- ``RecognitionEngine`` streaming (``stream_add`` / ``stream_run``): the
  cross-window carry the volume runner feeds, batches of ``quantum`` and
  power-of-two tails only (engines.py:1076-1182).

Copies between host and card never wait for other work: uploads are staged
in pinned memory and copied with ``non_blocking=True``; results come back
the same way, each with a CUDA event that its reader waits on. PyTorch's
caching host allocator is the staging pool: it hands a pinned block out
again only after the copies recorded on it have completed. The recognizer
runs on its own CUDA stream, so a volume's recognition (flush thread) and
detection (main thread) overlap on the card.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ocr_inference_tpu_torch.core.config import LINE_CLASS_THRESHOLD
from ocr_inference_tpu_torch.core.data import BatchConfig, OCRModelConfig
from ocr_inference_tpu_torch.decode.ctc import (
    greedy_decode_packed,
    ids_to_tokens,
    unpack_greedy_host,
)
from ocr_inference_tpu_torch.ops import kernels, packing, tiling
from ocr_inference_tpu_torch.ops.imaging import resize_bilinear, rgb_to_gray


def host_buffer(shape, device: torch.device) -> torch.Tensor:
    """An uninitialized uint8 host tensor to stage an upload to ``device``
    in: pinned when the upload goes to the card."""
    return torch.empty(shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


class PendingHost:
    """A device tensor's copy to the host, queued when this is made;
    ``get`` waits for that copy alone (an event recorded right after it),
    not for the work queued later on the card."""

    def __init__(self, t: torch.Tensor):
        if t.device.type != "cuda":
            self._host, self._event = t, None
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        # a blocking event yields the waiting thread's core while it waits
        self._event = torch.cuda.Event(blocking=True)
        self._event.record(torch.cuda.current_stream(t.device))

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class SegmentationEngine:
    """Page -> line mask (sigmoid, threshold 0.9, binary mask * 255;
    reference: inference.py:166-183)."""

    TILE_CHUNK = 32  # most tiles per UNet call (engines.py:140)

    def __init__(
        self,
        model: torch.nn.Module,
        device: torch.device,
        patch_size: int = 512,
        open_width_frac: float = 0.0,
    ):
        self.model = model
        self.device = device
        self.patch_size = patch_size
        # Horizontal opening erasing components narrower than this fraction
        # of the page width: the builder turns it on for stem-2 detectors,
        # whose thin tile-edge artifacts pass the contour filter
        # (engines.py:174-186, builder.py:110).
        self.open_width_frac = open_width_frac

    def _run_tiles(self, x: torch.Tensor) -> torch.Tensor:
        """Forward all tiles in chunks: one chunk of the tile count rounded
        up to a multiple of 8 (at most TILE_CHUNK), zero-padded."""
        n = x.shape[0]
        chunk = min(-(-n // 8) * 8, self.TILE_CHUNK)
        outs = []
        for start in range(0, n, chunk):
            block = x[start: start + chunk]
            real = block.shape[0]
            if real < chunk:
                block = F.pad(block, (0, 0, 0, 0, 0, 0, 0, chunk - real))
            outs.append(self.model(block)[:real])
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

    @torch.inference_mode()
    def predict_async(self, image: np.ndarray):
        """Queue a page's detection on the card; returns a zero-arg
        resolver giving the (H, W) uint8 mask, values 0/255.

        Everything from the upload to the bit-packed mask's copy to the
        host is queued here, with no wait on the card in between; the
        resolver waits only for that copy. A page of the wrong shape or
        type raises here, before anything is queued."""
        if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
            raise ValueError(
                f"expected an (H, W, 3) uint8 page, got {image.shape} "
                f"{image.dtype}")
        h, w = image.shape[:2]
        plan = tiling.plan_page(h, w, self.patch_size)
        staging = host_buffer(image.shape, self.device)
        np.copyto(staging.numpy(), image)  # any strides, one host copy
        page = staging.to(self.device, non_blocking=True)
        tiles = tiling.tile_page(tiling.preprocess_page(page, plan),
                                 self.patch_size)
        # binarize per tile, as the reference does (inference.py:132-139)
        bw = kernels.binarize_tiles(tiles)
        x = (bw.to(torch.float32) / 255.0)[:, None].expand(-1, 3, -1, -1)
        logits = self._run_tiles(x)
        pred = (torch.sigmoid(logits[:, 0]) > LINE_CLASS_THRESHOLD).float()
        merged = tiling.crop_padding(
            tiling.stitch_tiles(pred, plan.y_steps), plan.pad_x, plan.pad_y
        )
        # the reference truncates (astype uint8) before *255: >= 1.0 survives
        m = resize_bilinear(merged, h, w) >= 1.0
        if self.open_width_frac > 0:
            k = max(int(w * self.open_width_frac) | 1, 3)
            m = self._open_horizontal(m, k)
        packed = PendingHost(packing.pack_mask(m))

        def resolve() -> np.ndarray:
            return packing.unpack_mask(packed.get(), w) * np.uint8(255)

        return resolve

    def predict(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB page -> (H, W) uint8 mask, values 0/255."""
        return self.predict_async(image)()


class StreamState:
    """Cross-call carry for RecognitionEngine's streaming API: prepared
    line canvases grouped by width bucket, each tagged with the caller's
    token. Owned by one consumer thread (VolumeRunner's flush worker)."""

    def __init__(self):
        self.by_width: dict[int, list] = {}


class RecognitionEngine:
    """Batched line recognizer (reference: OCRInference,
    inference.py:279-429): canvases padded into width buckets on the host,
    then per (bucket, batch): line binarize kernel -> [-1, 1] -> Easter2 ->
    greedy CTC on the card."""

    # streaming batches: full batches of this many lines, power-of-two
    # tails (engines.py:1076-1094)
    STREAM_QUANTUM = 32
    # Every Easter2 call runs exactly this many canvases, zero rows after
    # the real ones. cuDNN picks its algorithm by the batch size, and in
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
    ):
        self.model = model
        self.config = config
        self.device = device
        self.batch_cfg = batch_cfg or BatchConfig()
        self.charset = list(config.charset)
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

    def _forward(self, host: torch.Tensor) -> PendingHost:
        """Queue one (B, H, W) uint8 batch, B a multiple of MODEL_BATCH:
        upload, line binarize kernel, Easter2 in calls of MODEL_BATCH,
        greedy CTC, and the packed result's copy to the host."""
        gray = host.to(self.device, non_blocking=True)
        bw = kernels.binarize_lines(gray)
        x = bw.to(torch.float32) / 127.5 - 1.0
        logits = torch.cat([self.model(c) for c in x.split(self.MODEL_BATCH)])
        return PendingHost(greedy_decode_packed(logits))

    def _dispatch(self, width: int, canvases: list[np.ndarray],
                  padded_b: int) -> PendingHost:
        """One forward of a (padded_b, width) batch, zero rows after the
        real ones; counted in ``occupancy``."""
        key = (width, len(canvases), padded_b)
        self.occupancy[key] = self.occupancy.get(key, 0) + 1
        host = host_buffer((self._rows(padded_b), self.config.input_height,
                            width), self.device)
        rows = host.numpy()
        for i, canvas in enumerate(canvases):
            rows[i] = canvas
        rows[len(canvases):] = 0
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

    @torch.inference_mode()
    def run_batch(self, line_images: Sequence[np.ndarray],
                  pre_pad: bool = False) -> list[str]:
        """Recognize many lines; returns texts in input order. Every batch
        is queued before the first result is read."""
        prepared = [
            (i, self.prepare_canvas(img, pre_pad))
            for i, img in enumerate(line_images)
            if img.shape[0] > 0 and img.shape[1] > 0
        ]
        with self._on_stream():
            pending = [(idxs, self._dispatch(width, canvases, b))
                       for width, b, idxs, canvases in self._batches(prepared)]
        texts: dict[int, str] = {}
        for idxs, p in pending:
            texts.update(self._texts(idxs, p))
        return [texts.get(i, "") for i in range(len(line_images))]

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

"""Device engines: tiled line segmentation and bucketed line recognition.

Counterpart of ocr_inference_tpu/pipeline/engines.py (reference:
BDRC/inference.py:121-429), without jit caches, mesh, streaming, beams or
the LM. Binarizing runs on the card through the hand-written kernel
(ops/kernels.py) in both engines — the JAX default path does it on the
host with cv2 and uploads packed bits; the kernel gives the same bytes.

- ``SegmentationEngine`` (line mode): page -> tiles -> binarize kernel ->
  UNet in chunks rounded to 8 -> sigmoid > 0.9, stitch, crop, resize,
  ``>= 1.0``, horizontal opening -> bit-packed mask to the host
  (engines.py:340-380, :440-466).
- ``RecognitionEngine.run_batch``: host canvas pad per width bucket,
  batches rounded to {1, 2, 4, 8, 16, 24, ...}, line binarize kernel,
  Easter2, greedy CTC on the card (engines.py:861-923).
"""

from __future__ import annotations

from typing import Sequence

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
    def predict(self, image: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB page -> (H, W) uint8 mask, values 0/255."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected an (H, W, 3) page, got {image.shape}")
        h, w = image.shape[:2]
        plan = tiling.plan_page(h, w, self.patch_size)
        page = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
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
        bits = packing.unpack_mask(packing.pack_mask(m).cpu().numpy(), w)
        return bits * np.uint8(255)


class RecognitionEngine:
    """Batched line recognizer (reference: OCRInference,
    inference.py:279-429): canvases padded into width buckets on the host,
    then per (bucket, batch): line binarize kernel -> [-1, 1] -> Easter2 ->
    greedy CTC on the card."""

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

    def _buckets(self) -> tuple[int, ...]:
        w = self.config.input_width
        return tuple(b for b in self.batch_cfg.width_buckets if b < w) + (w,)

    def prepare_canvas(self, line_image: np.ndarray) -> np.ndarray:
        """Strip -> (input_height, bucket) uint8 gray canvas. RGB strips are
        padded in 3 channels and then converted (engines.py:725-745); gray
        strips are padded directly (RGB2GRAY of a replicated gray is the
        identity)."""
        img = line_image
        if img.ndim == 3 and img.shape[2] == 1:
            img = img[..., 0]
        height = self.config.input_height
        bucket = tiling.bucket_for_width(img.shape[1], img.shape[0], height,
                                         self._buckets())
        canvas = tiling.pad_ocr_line(torch.from_numpy(img), bucket, height)
        if canvas.ndim == 3:
            canvas = rgb_to_gray(canvas)
        return canvas.numpy()

    def _batches(self, prepared: list[tuple[int, np.ndarray]]):
        """Group canvases by bucket width and yield (width, idxs, array)
        with the batch rounded up to {1, 2, 4, 8, 16, 24, 32, ...}
        (engines.py:871-893), zero rows after the real ones."""
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
                b = min(b, bmax)
                arr = np.zeros((b, self.config.input_height, width), np.uint8)
                for i, (_, canvas) in enumerate(chunk):
                    arr[i] = canvas
                yield width, [idx for idx, _ in chunk], arr

    @torch.inference_mode()
    def run_batch(self, line_images: Sequence[np.ndarray]) -> list[str]:
        """Recognize many lines; returns texts in input order."""
        prepared = [
            (i, self.prepare_canvas(img))
            for i, img in enumerate(line_images)
            if img.shape[0] > 0 and img.shape[1] > 0
        ]
        texts: dict[int, str] = {}
        for _, idxs, arr in self._batches(prepared):
            gray = torch.from_numpy(arr).to(self.device)
            bw = kernels.binarize_lines(gray)
            x = bw.to(torch.float32) / 127.5 - 1.0
            packed = greedy_decode_packed(self.model(x)).cpu().numpy()
            ids, lengths, _ = unpack_greedy_host(packed)
            for row, idx in enumerate(idxs):
                texts[idx] = "".join(ids_to_tokens(
                    ids[row], int(lengths[row]), self.charset,
                    self.config.add_blank,
                ))
        return [texts.get(i, "") for i in range(len(line_images))]

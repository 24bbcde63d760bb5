"""Directory image dataset, counterpart of ocr_inference_tpu/io/dataset.py
(reference: ImageInferenceDataset, BDRC/inference.py:829-857): the
host-side image source for batch runs, plain iteration plus a thread-pooled
prefetch iterator.

Pages are read with io/images.py ``read_image`` (PNG, JPEG, TIFF as
cv2.imread reads them) in place of cv2.imread. Its decoders run in native
code called through ctypes, which releases the GIL, so the prefetch
threads decode pages in parallel."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Iterator

import numpy as np

from ocr_inference_tpu_torch.io.images import read_image


class ImageInferenceDataset:
    """Sorted directory of images; items are (image, meta) like the
    reference's (tensor, meta) pairs, the image RGB for ``mode="rgb"`` and
    BGR (cv2.imread's order) otherwise."""

    EXTENSIONS = (".jpg", ".png", ".jpeg", ".tif", ".tiff")

    def __init__(self, root_dir: str, mode: str = "rgb"):
        self._mode = mode
        self.paths = sorted(
            p
            for p in glob(os.path.join(root_dir, "*"))
            if p.lower().endswith(self.EXTENSIONS)
        )

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int):
        path = self.paths[idx]
        img = read_image(path)
        if img is None:
            raise IOError(f"failed to read {path}")
        if self._mode != "rgb":
            img = np.ascontiguousarray(img[..., ::-1])
        meta = {
            "image_name": os.path.basename(path),
            "orig_shape": (img.shape[0], img.shape[1]),
        }
        return img, meta

    get_item = __getitem__  # reference API alias (inference.py:841)

    def iter_prefetched(self, num_workers: int = 4) -> Iterator:
        """Threaded prefetch iterator (replaces DataLoader workers)."""
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            yield from pool.map(self.__getitem__, range(len(self)))

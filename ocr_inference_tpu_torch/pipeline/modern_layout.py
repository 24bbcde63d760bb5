"""Modern-book layout detection -> per-page JSON bboxes.

Counterpart of ocr_inference_tpu/pipeline/modern_layout.py (reference:
BDRC/inference.py:860-961): pages stream through the layout
SegmentationEngine (softmax over the classes, threshold, masks resized to
the page on the card) in groups of ``predict_many_batched``, then each
class's contours are unioned into one bbox and written as
``{class: {bbox: {x, y, w, h}}}`` JSON per page.

Pages are read with io/images.py ``read_image`` (PNG and JPEG by the JAX
runner's glob, as cv2.imread reads them). A directory holding a page of
a format or variant it does not decode (a JPEG 2000 TIFF, a BMP named
.jpg, ...) raises NotImplementedError naming it before any page is
run.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Optional

import numpy as np

from ocr_inference_tpu_torch.core.assets import get_filename
from ocr_inference_tpu_torch.core.data import LayoutDetectionConfig
from ocr_inference_tpu_torch.geometry import backend as geo
from ocr_inference_tpu_torch.geometry import get_union_bbox
from ocr_inference_tpu_torch.io.images import read_image, unsupported
from ocr_inference_tpu_torch.pipeline.engines import SegmentationEngine


class ModernBookFormatLayoutDetection:
    """Layout detection for modern book scans (headers/footers/...)."""

    def __init__(
        self,
        config: LayoutDetectionConfig,
        engine: Optional[SegmentationEngine] = None,
        allow_random: bool = False,
        device=None,
    ):
        self.config = config
        self.classes = config.classes
        if engine is None:
            from ocr_inference_tpu_torch.pipeline.builder import (
                build_detection_engine,
            )

            engine = build_detection_engine(config, device=device,
                                            allow_random=allow_random)
        self.engine = engine

    def post_process_sample(self, prediction: np.ndarray,
                            class_index: int) -> dict | None:
        """Union bbox of one class channel (reference: inference.py:899-918)."""
        contours = geo.find_contours(prediction[:, :, class_index])
        if len(contours) == 0:
            return None
        bbox, _ = get_union_bbox(list(contours))
        if bbox is None:
            return None
        return {"bbox": {"x": bbox.x, "y": bbox.y, "w": bbox.w, "h": bbox.h}}

    def extract_json_data(
        self,
        image_name: str,
        prediction: np.ndarray,
        filter_classes: Optional[list[str]],
        output_dir: str,
    ) -> dict:
        """(reference: inference.py:868-891)."""
        found: dict[str, dict] = {}
        wanted = (
            [c for c in self.classes if c in filter_classes]
            if filter_classes
            else self.classes
        )
        for class_name in wanted:
            bbox = self.post_process_sample(prediction,
                                            self.classes.index(class_name))
            if bbox is not None:
                found[class_name] = bbox
        self.save_to_json(get_filename(image_name), output_dir, found)
        return found

    def save_to_json(self, image_name: str, output_dir: str, record: dict):
        with open(f"{output_dir}/{image_name}.json", "w",
                  encoding="UTF-8") as f:
            json.dump(record, f, ensure_ascii=False, indent=1)

    def run(
        self,
        directory: str,
        output_dir: str,
        filter_classes: Optional[list[str]] = None,
        batch_size: int = 4,
        num_workers: int = 4,
        class_threshold: float = 0.8,
    ) -> dict:
        """Process every image in ``directory`` (reference:
        inference.py:921-961), pages read by ``num_workers`` threads and
        detected ``batch_size`` at a time in one tile stream. A page that
        cannot be read is skipped, as the JAX runner skips it."""
        if filter_classes:
            for f_class in filter_classes:
                if f_class not in self.classes:
                    raise ValueError(
                        f"ERROR: provided filter classes: {filter_classes} "
                        "are not part of the model's classes!"
                    )
        paths = sorted(
            p
            for p in glob(os.path.join(directory, "*"))
            if p.lower().endswith((".jpg", ".png", ".jpeg"))
        )
        refused = [f"{p} ({why})" for p in paths if (why := unsupported(p))]
        if refused:
            raise NotImplementedError(
                "these pages cannot be read: " + ", ".join(refused))
        os.makedirs(output_dir, exist_ok=True)

        results = {}
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            loaded = (
                (path, img)
                for path, img in zip(paths, pool.map(read_image, paths))
                if img is not None
            )
            for path, _, pred in self.engine.predict_many_batched(
                loaded, batch_size=batch_size, class_threshold=class_threshold
            ):
                results[path] = self.extract_json_data(
                    os.path.basename(path), pred, filter_classes, output_dir
                )
        return results

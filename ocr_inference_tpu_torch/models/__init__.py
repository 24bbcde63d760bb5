"""Networks (UNet, DeepLabV3+, the Easter2 family, CRNN) and the
Flax-msgpack weight reader."""

from ocr_inference_tpu_torch.models.recognition import (  # noqa: F401
    CRNN,
    Easter2,
    build_recognizer,
)
from ocr_inference_tpu_torch.models.segmentation import (  # noqa: F401
    DeepLabV3Plus,
    UNet,
)

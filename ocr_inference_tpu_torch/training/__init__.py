"""Training: CTC fine-tuning for the recognizers and BCE + dice tile
training for the segmentation nets (counterpart of
ocr_inference_tpu/training)."""

from ocr_inference_tpu_torch.training.train import (  # noqa: F401
    TrainState,
    ctc_loss_fn,
    init_train_state,
    make_optimizer,
    make_train_step,
    synthetic_ctc_batch,
)
from ocr_inference_tpu_torch.training.segmentation import (  # noqa: F401
    init_seg_train_state,
    make_seg_train_step,
    seg_loss_fn,
    synthetic_seg_batch,
)

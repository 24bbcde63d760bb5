"""CTC decoding (greedy best path on the device, host beam search) and
n-gram LM scoring."""

from ocr_inference_tpu_torch.decode.arpa_lm import ArpaLM  # noqa: F401
from ocr_inference_tpu_torch.decode.ctc import (  # noqa: F401
    Beam,
    beam_search,
    greedy_decode,
    ids_to_tokens,
)
from ocr_inference_tpu_torch.decode.decoder import CTCDecoder  # noqa: F401

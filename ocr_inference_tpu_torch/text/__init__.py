"""Tibetan text handling: EWTS transliteration, stack tokenization, label
encoders (copy of ocr_inference_tpu.text)."""

from ocr_inference_tpu_torch.text.encoders import (  # noqa: F401
    LabelEncoder,
    StackEncoder,
    WylieEncoder,
    postprocess_wylie_label,
    preprocess_unicode,
)
from ocr_inference_tpu_torch.text.ewts import (  # noqa: F401
    normalize_unicode,
    to_unicode,
    to_wylie,
    tokenize_in_stacks,
)


class Converter:
    """pyewts.pyewts()-compatible object surface
    (reference: BDRC/inference.py:452, exporter.py:40)."""

    def toUnicode(self, wylie: str) -> str:  # noqa: N802
        return to_unicode(wylie)

    def toWylie(self, unicode_text: str) -> str:  # noqa: N802
        return to_wylie(unicode_text)

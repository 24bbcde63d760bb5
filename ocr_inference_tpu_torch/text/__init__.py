"""EWTS transliteration (copy of ocr_inference_tpu.text's converter)."""

from ocr_inference_tpu_torch.text.ewts import to_unicode, to_wylie


class Converter:
    """pyewts.pyewts()-compatible object surface
    (reference: BDRC/inference.py:452, exporter.py:40)."""

    def toUnicode(self, wylie: str) -> str:  # noqa: N802
        return to_unicode(wylie)

    def toWylie(self, unicode_text: str) -> str:  # noqa: N802
        return to_wylie(unicode_text)

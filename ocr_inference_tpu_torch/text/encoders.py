"""Label encoders + text pre/post-processing conventions (copy of
ocr_inference_tpu/text/encoders.py).

Parity with the reference label pipeline (reference: BDRC/label_encoder.py):
Unicode cleanup rules, the BDRC rare-sign single-char escapes, the space->'§'
tsheg encoding, and Wylie/Stack charset encoders used for training labels and
CER evaluation.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod

from ocr_inference_tpu_torch.text import ewts


def preprocess_unicode(label: str, full_bracket_removal: bool = False) -> str:
    """Clean raw e-text lines (reference: BDRC/label_encoder.py:10-32)."""
    label = label.replace("\uf8f0", " ")
    label = label.replace("\xa0", "")
    label = label.replace("\x10", "")
    label = label.replace("\t", "")
    label = label.replace("\u200d", "")
    label = label.replace("\uf037", "")
    label = label.replace("\uf038", "")
    label = label.replace("\u0f0c", "\u0f0b")  # no-break tsheg -> tsheg

    if full_bracket_removal:
        label = re.sub(r"[\[(].*?[\])]", "", label)
    else:
        label = re.sub("[()]", "", label)
    return label


def postprocess_wylie_label(label: str) -> str:
    """BDRC escape conventions for rare signs + the '§' tsheg encoding
    (reference: BDRC/label_encoder.py:35-54). Applied after toWylie so the
    model charset stays small."""
    label = label.replace("\\u0f85", "&")
    label = label.replace("\\u0f09", "ä")
    label = label.replace("\\u0f13", "ö")
    label = label.replace("\\u0f12", "ü")
    label = label.replace("\\u0fd3", "@")
    label = label.replace("\\u0fd4", "#")
    label = label.replace("\\u0f00", "oM")
    label = label.replace("\\u0f7f", "}")
    label = label.replace("＠", "@")
    label = label.replace("।", "|")
    label = label.replace("*", " ")
    label = label.replace("  ", " ")
    label = label.replace("_", "")
    label = label.replace("[", "")
    label = label.replace("]", "")
    label = label.replace(" ", "§")  # tsheg encoding
    return label


class LabelEncoder(ABC):
    """Charset-bound label codec (reference: BDRC/label_encoder.py:57-101).

    The CTC vocab inserts " " at index 0 (the training-side blank
    convention); encode/decode shift charset indices by +1 accordingly.
    """

    def __init__(self, charset: str | list[str], name: str):
        self.name = name
        self._charset = list(charset)
        self.ctc_vocab = self._charset.copy()
        self.ctc_vocab.insert(0, " ")

    @abstractmethod
    def read_label(self, label_path: str):
        raise NotImplementedError

    @property
    def charset(self) -> list[str]:
        return self._charset

    @property
    def concat_charset(self) -> str:
        return "".join(self._charset)

    @property
    def num_classes(self) -> int:
        return len(self._charset) + 1

    def encode(self, label) -> list[int]:
        enc = []
        for x in label:
            if x in self._charset:
                enc.append(self._charset.index(x) + 1)
            else:
                enc.append(-1)
                print(f"WARNING: {x} not in charset")
        return enc

    def decode(self, inputs: list[int]) -> str:
        return "".join(self._charset[x - 1] for x in inputs)

    def ctc_decode(self, logits) -> str:
        from ocr_inference_tpu_torch.decode.ctc import beam_search

        beams = beam_search(logits, self._charset, add_blank=True, beam_width=16)
        return beams[0].text.replace(" ", "") if beams else ""


class StackEncoder(LabelEncoder):
    """Charset units are whole Tibetan stacks
    (reference: BDRC/label_encoder.py:104-123)."""

    def __init__(self, charset: list[str]):
        super().__init__(charset, "stack")

    def read_label(self, label_path: str, normalize: bool = True) -> list[str]:
        with open(label_path, "r", encoding="utf-8") as f:
            label = f.readline().rstrip("\n")
        if normalize:
            label = ewts.normalize_unicode(label)
        label = label.replace(" ", "")
        label = preprocess_unicode(label)
        return ewts.tokenize_in_stacks(label)


class WylieEncoder(LabelEncoder):
    """Charset units are Wylie characters
    (reference: BDRC/label_encoder.py:126-142)."""

    def __init__(self, charset: str | list[str]):
        super().__init__(charset, "wylie")

    def read_label(self, label_path: str) -> str:
        with open(label_path, "r", encoding="utf-8") as f:
            label = f.readline().rstrip("\n")
        label = preprocess_unicode(label)
        label = ewts.to_wylie(label)
        label = postprocess_wylie_label(label)
        return label

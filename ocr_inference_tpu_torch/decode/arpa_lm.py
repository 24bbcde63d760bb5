"""ARPA n-gram language model with Katz backoff, the plain Python scorer
(copy of ocr_inference_tpu/decode/arpa_lm.py).

The reference rescores CTC beams with KenLM models through pyctcdecode
(reference: BDRC/inference.py:95-106). This scorer reads the ARPA text
file into float64 tables; its C++ twin, ``native.NativeArpaLM`` (float32
tables, as the JAX package's), serves the same ``score(context, token) ->
log10 prob`` interface and is the one the decoder loads.
"""

from __future__ import annotations

from pathlib import Path


class ArpaLM:
    """n-gram LM over charset-unit tokens, loaded from an ARPA text file."""

    def __init__(self, arpa_path: str | Path):
        self.order = 0
        # ngram (tuple of token strings) -> (log10 prob, log10 backoff)
        self._table: dict[tuple[str, ...], tuple[float, float]] = {}
        self._load(Path(arpa_path))

    def _load(self, path: Path) -> None:
        section = 0  # current n-gram order being read
        with open(path, "r", encoding="utf-8") as f:
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1 : line.index("-")])
                    self.order = max(self.order, section)
                    continue
                if line in ("\\data\\", "\\end\\") or line.startswith("ngram "):
                    continue
                if section == 0:
                    continue
                parts = line.split()  # ARPA tokens never contain whitespace
                if len(parts) < section + 1:
                    continue
                logp = float(parts[0])
                tokens = tuple(parts[1 : 1 + section])
                backoff = (
                    float(parts[1 + section]) if len(parts) > 1 + section else 0.0
                )
                self._table[tokens] = (logp, backoff)

    def score(self, context: tuple[str, ...], token: str) -> float:
        """log10 P(token | context) with Katz backoff.

        KenLM semantics: words outside the unigram vocabulary are mapped
        to ``<unk>`` BEFORE scoring (kenlm lm/vocab id 0), so an unknown
        context word contributes <unk>'s backoff weight — this keeps the
        text scorer bit-consistent with the .binary readers
        (decode.kenlm_binary / decode.kenlm_trie), which operate on ids."""
        def norm(t: str) -> str:
            return t if (t,) in self._table else "<unk>"

        token = norm(token)
        context = tuple(
            norm(t)
            for t in (context[-(self.order - 1) :] if self.order > 1 else ())
        )
        backoff_sum = 0.0
        while True:
            entry = self._table.get(context + (token,))
            if entry is not None:
                return backoff_sum + entry[0]
            if not context:
                # <unk> itself unmodeled: a harsh finite penalty
                return backoff_sum - 10.0
            bo = self._table.get(context)
            backoff_sum += bo[1] if bo is not None else 0.0
            context = context[1:]

    def make_score_fn(self, charset: list[str], add_blank: bool = True):
        """Adapter: (prefix_ids, next_id) -> log10 prob, for beam_search.

        Vocab ids use the +1 blank shift when add_blank
        (reference: BDRC/inference.py:108-112).
        """
        def to_token(vid: int) -> str:
            return charset[vid - 1] if add_blank else charset[vid]

        def fn(prefix_ids: tuple[int, ...], next_id: int) -> float:
            context = tuple(to_token(i) for i in prefix_ids)
            return self.score(context, to_token(next_id))

        return fn

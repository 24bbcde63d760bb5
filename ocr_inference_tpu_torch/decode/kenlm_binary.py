"""KenLM ``.binary`` (probing format) reader + writer (copy of
ocr_inference_tpu/decode/kenlm_binary.py; it writes the same bytes).

The reference's primary LM artifact is a KenLM binary model — its
``download_kenlm`` fetches a ``.binary``/``.arpa`` pair and hands the binary
to pyctcdecode (reference: BDRC/utils.py:132-159, BDRC/inference.py:97-101).
This module gives the framework its own binary support:

- :class:`KenLMBinary` — memory-mapped reader of PROBING-format binaries
  (kenlm's default ``build_binary`` output): linear-probing hash tables of
  MurmurHash64A-keyed n-grams over word ids, scored with the same Katz
  backoff recursion as :class:`decode.arpa_lm.ArpaLM`.
- :func:`arpa_to_binary` — converter producing the same layout, used both
  as the documented migration path and so binaries load via mmap + hashing
  instead of re-parsing ARPA text on every start.

Format layout implemented (kenlm lm/binary_format.cc, lm/vocab.cc,
util/probing_hash_table.hh, lm/search_hashed.hh):

    Sanity(88B: magic"...format version 5" + float/int probes)
    FixedWidthParameters(20B: order, probing_multiplier, model_type,
                         has_vocabulary, search_version)
    uint64 counts[order]            (then pad to 8)
    vocab:  ALIGN8(8B header) + probing table of {u64 murmur(word), u32 id}
            (12B packed entries; invalid key 0)
    search: unigram (counts[0]+1) x {f32 prob, f32 backoff}
            middle tables, orders 2..N-1: {u64 key, f32 prob, f32 backoff}
            longest table, order N:       {u64 key, f32 prob}
            keys chain CombineWordHash(seed=words[0], next_word)
    words:  null-separated vocabulary strings (when has_vocabulary)

CAVEAT (documented divergence): no real kenlm-built binary was available to
test against, so cross-implementation compatibility is untested — the
layout follows the published kenlm structures, round-trips through this
module are exact, and ``CTCDecoder`` falls back to the sibling ``.arpa``
(which the reference always downloads alongside) whenever a binary fails to
parse. TRIE binaries are handled by the sibling decode.kenlm_trie module
(dispatch via kenlm_trie.open_binary); quantized/array variants are
rejected with a clear message.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path

import numpy as np

MAGIC = b"mmap lm http://kheafield.com/code format version 5\n\x00"
MAGIC_PREFIX = b"mmap lm http://kheafield.com/code format version"
_MAGIC_FIELD = (len(MAGIC) + 7) // 8 * 8          # ALIGN8 -> 56
_SANITY_SIZE = 88
_PARAMS_SIZE = 20
MODEL_PROBING = 0

_COMBINE_A = 8978948897894561157
_COMBINE_B = 17894857484156487943
_U64 = (1 << 64) - 1


def _align8(n: int) -> int:
    return (n + 7) // 8 * 8


def murmur64a(data: bytes, seed: int = 0) -> int:
    """util::MurmurHash64A (public domain reference algorithm)."""
    m = 0xC6A4A7935BD1E995
    r = 47
    h = (seed ^ (len(data) * m)) & _U64
    n_blocks = len(data) // 8
    for i in range(n_blocks):
        (k,) = struct.unpack_from("<Q", data, i * 8)
        k = (k * m) & _U64
        k ^= k >> r
        k = (k * m) & _U64
        h = ((h ^ k) * m) & _U64
    tail = data[n_blocks * 8 :]
    if tail:
        k = int.from_bytes(tail, "little")
        h = ((h ^ k) * m) & _U64
    h ^= h >> r
    h = (h * m) & _U64
    h ^= h >> r
    return h


def combine_word_hash(current: int, next_word: int) -> int:
    """lm/model.cc detail::CombineWordHash."""
    return (
        ((current * _COMBINE_A) & _U64)
        ^ (((1 + next_word) * _COMBINE_B) & _U64)
    ) & _U64


def ngram_hash(word_ids: list[int]) -> int:
    """Chained hash of an n-gram (n >= 2): seed is the first word id."""
    h = word_ids[0]
    for w in word_ids[1:]:
        h = combine_word_hash(h, w)
    return h


def _buckets_for(entries: int, multiplier: float) -> int:
    return max(entries + 1, int(multiplier * float(entries)))


class _ProbingTable:
    """Read-side linear-probing hash table over packed little-endian
    entries (invalid key 0)."""

    def __init__(self, buf, offset: int, buckets: int, entry_size: int,
                 n_values: int):
        self.buckets = buckets
        raw = np.frombuffer(
            buf, dtype=np.uint8, count=buckets * entry_size, offset=offset
        ).reshape(buckets, entry_size)
        self.keys = raw[:, :8].copy().view(np.uint64).reshape(buckets)
        self.vals = (
            raw[:, 8 : 8 + 4 * n_values].copy().view("<f4").reshape(
                buckets, n_values
            )
        )
        self.end = offset + buckets * entry_size

    def lookup(self, key: int):
        i = key % self.buckets
        k = np.uint64(key)
        keys = self.keys
        for _ in range(self.buckets):
            cur = keys[i]
            if cur == k:
                return self.vals[i]
            if cur == 0:
                return None
            i += 1
            if i == self.buckets:
                i = 0
        return None


class KenLMBinary:
    """Memory-mapped KenLM probing-format model with the ArpaLM scoring
    interface (``score(context_tokens, token) -> log10 prob``)."""

    def __init__(self, path: str | Path):
        path = Path(path)
        self._file = open(path, "rb")
        buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = buf
        magic = bytes(buf[:_MAGIC_FIELD])
        if not magic.startswith(MAGIC_PREFIX):
            raise ValueError(f"{path}: not a KenLM binary (bad magic)")
        if not magic.startswith(MAGIC):
            raise ValueError(
                f"{path}: unsupported KenLM binary format version "
                "(expected 5)"
            )
        (order, mult, model_type, has_vocab, _search_version) = (
            struct.unpack_from("<B3xfi?3xI", buf, _SANITY_SIZE)
        )
        if model_type != MODEL_PROBING:
            raise ValueError(
                f"{path}: only PROBING KenLM binaries are supported "
                f"(model_type={model_type}); rebuild with "
                "build_binary probing, or use the sibling .arpa"
            )
        self.order = order
        counts = list(
            struct.unpack_from(
                f"<{order}Q", buf, _SANITY_SIZE + _PARAMS_SIZE
            )
        )
        self.counts = counts
        off = _align8(_SANITY_SIZE + _PARAMS_SIZE + 8 * order)

        # vocabulary probing table
        off += _align8(8)  # ProbingVocabularyHeader
        vbuckets = _buckets_for(counts[0], mult)
        vraw = np.frombuffer(
            buf, dtype=np.uint8, count=vbuckets * 12, offset=off
        ).reshape(vbuckets, 12)
        self._vocab_keys = vraw[:, :8].copy().view(np.uint64).reshape(vbuckets)
        self._vocab_ids = vraw[:, 8:12].copy().view("<u4").reshape(vbuckets)
        self._vbuckets = vbuckets
        off += vbuckets * 12

        # unigram array
        self._unigram = np.frombuffer(
            buf, dtype="<f4", count=(counts[0] + 1) * 2, offset=off
        ).reshape(counts[0] + 1, 2)
        off += (counts[0] + 1) * 8

        # middle tables (orders 2..N-1), longest table (order N)
        self._middle: list[_ProbingTable] = []
        for n in range(2, order):
            t = _ProbingTable(
                buf, off, _buckets_for(counts[n - 1], mult), 16, 2
            )
            self._middle.append(t)
            off = t.end
        self._longest = None
        if order >= 2:
            self._longest = _ProbingTable(
                buf, off, _buckets_for(counts[order - 1], mult), 12, 1
            )
            off = self._longest.end

        # trailing null-separated vocabulary strings
        self._word_ids: dict[str, int] = {}
        if has_vocab:
            words = bytes(buf[off:]).split(b"\x00")
            idx = 0
            for wbytes in words:
                if not wbytes:
                    continue
                self._word_ids[wbytes.decode("utf-8", "replace")] = idx
                idx += 1

    def close(self):
        try:
            self._buf.close()
            self._file.close()
        except Exception:
            pass

    # -- vocab --

    def token_id(self, token: str) -> int:
        if self._word_ids:
            return self._word_ids.get(token, 0)
        h = murmur64a(token.encode("utf-8"))
        i = h % self._vbuckets
        for _ in range(self._vbuckets):
            cur = self._vocab_keys[i]
            if cur == np.uint64(h):
                return int(self._vocab_ids[i])
            if cur == 0:
                return 0  # <unk>
            i += 1
            if i == self._vbuckets:
                i = 0
        return 0

    # -- scoring (same Katz recursion as ArpaLM.score) --

    def _lookup(self, ids: list[int]):
        """(log10 prob, log10 backoff) of an n-gram by word ids, or None."""
        n = len(ids)
        if n == 1:
            wid = ids[0] if ids[0] <= self.counts[0] else 0
            p, b = self._unigram[wid]
            return float(p), float(b)
        if n == self.order:
            v = self._longest.lookup(ngram_hash(ids))
            return (float(v[0]), 0.0) if v is not None else None
        t = self._middle[n - 2]
        v = t.lookup(ngram_hash(ids))
        return (float(v[0]), float(v[1])) if v is not None else None

    def score(self, context: tuple[str, ...], token: str) -> float:
        """log10 P(token | context), Katz backoff — the same recursion as
        ArpaLM.score, over hash lookups instead of a dict."""
        ids = [self.token_id(t) for t in context] + [self.token_id(token)]
        return self._score_ids(ids)

    def _score_ids(self, ids: list[int]) -> float:
        ids = ids[-self.order :]
        backoff_sum = 0.0
        while True:
            hit = self._lookup(ids)
            if hit is not None:
                return backoff_sum + hit[0]
            if len(ids) == 1:
                # OOV: fall back to <unk> (id 0)
                return backoff_sum + float(self._unigram[0][0])
            bo = self._lookup(ids[:-1])
            backoff_sum += bo[1] if bo is not None else 0.0
            ids = ids[1:]

    def make_score_fn(self, charset: list[str], add_blank: bool = True):
        """Adapter matching ArpaLM.make_score_fn (vocab +1 blank shift)."""
        tids = [self.token_id(c) for c in charset]

        def fn(prefix_ids: tuple[int, ...], next_id: int) -> float:
            shift = 1 if add_blank else 0
            ids = [tids[i - shift] for i in prefix_ids] + [
                tids[next_id - shift]
            ]
            return self._score_ids(ids)

        return fn


# ---------------------------------------------------------------------------
# Writer / converter
# ---------------------------------------------------------------------------

def _write_probing_table(entries: list[tuple[int, bytes]], buckets: int,
                         entry_size: int) -> bytes:
    table = bytearray(buckets * entry_size)
    for key, payload in entries:
        i = key % buckets
        while True:
            (cur,) = struct.unpack_from("<Q", table, i * entry_size)
            if cur == 0:
                struct.pack_into("<Q", table, i * entry_size, key)
                table[i * entry_size + 8 : i * entry_size + entry_size] = (
                    payload
                )
                break
            i += 1
            if i == buckets:
                i = 0
    return bytes(table)


def arpa_to_binary(
    arpa_path: str | Path,
    binary_path: str | Path,
    probing_multiplier: float = 1.5,
) -> None:
    """Convert an ARPA text model into the probing binary layout above.

    The documented migration path for environments that only carry a
    ``.binary`` (reference downloads both, BDRC/utils.py:132-159) — and the
    fast-load format for the framework's own LMs.
    """
    from ocr_inference_tpu_torch.decode.arpa_lm import ArpaLM

    lm = ArpaLM(arpa_path)
    order = lm.order
    # vocabulary: unigram tokens, <unk> first at id 0
    unigrams = [g[0] for g in lm._table if len(g) == 1]
    vocab: list[str] = []
    if "<unk>" in unigrams:
        vocab.append("<unk>")
    vocab.extend(t for t in unigrams if t != "<unk>")
    if not vocab or vocab[0] != "<unk>":
        vocab.insert(0, "<unk>")
    ids = {t: i for i, t in enumerate(vocab)}
    counts = [0] * order
    for g in lm._table:
        counts[len(g) - 1] += 1

    out = bytearray()
    # Sanity
    magic = MAGIC + b"\x00" * (_MAGIC_FIELD - len(MAGIC))
    out += magic
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<II", 1, 0xFFFFFFFF)
    out += b"\x00" * 4
    out += struct.pack("<Q", 1)
    assert len(out) == _SANITY_SIZE
    # FixedWidthParameters + counts
    out += struct.pack(
        "<B3xfi?3xI", order, probing_multiplier, MODEL_PROBING, True, 0
    )
    out += struct.pack(f"<{order}Q", *counts)
    out += b"\x00" * (_align8(len(out)) - len(out))

    # vocab table
    out += b"\x00" * _align8(8)
    vbuckets = _buckets_for(counts[0], probing_multiplier)
    ventries = [
        (murmur64a(t.encode("utf-8")), struct.pack("<I", i))
        for t, i in ids.items()
    ]
    out += _write_probing_table(ventries, vbuckets, 12)

    # unigram array; an unmodeled <unk> gets ArpaLM's -10 OOV penalty so
    # binary and text scoring agree on OOV tokens
    uni = np.zeros((counts[0] + 1, 2), "<f4")
    if "<unk>" not in unigrams:
        uni[0] = (-10.0, 0.0)
    for gram, (prob, backoff) in lm._table.items():
        if len(gram) == 1:
            uni[ids.get(gram[0], 0)] = (prob, backoff)
    out += uni.tobytes()

    # middle + longest tables
    for n in range(2, order + 1):
        entries = []
        for gram, (prob, backoff) in lm._table.items():
            if len(gram) != n:
                continue
            key = ngram_hash([ids.get(t, 0) for t in gram])
            if n == order:
                entries.append((key, struct.pack("<f", prob)))
            else:
                entries.append((key, struct.pack("<ff", prob, backoff)))
        buckets = _buckets_for(counts[n - 1], probing_multiplier)
        out += _write_probing_table(
            entries, buckets, 12 if n == order else 16
        )

    # trailing word strings
    out += b"\x00".join(t.encode("utf-8") for t in vocab) + b"\x00"
    Path(binary_path).write_bytes(bytes(out))

"""KenLM ``.binary`` TRIE-format reader + writer (copy of
ocr_inference_tpu/decode/kenlm_trie.py; it writes the same bytes).

``build_binary trie`` is kenlm's compact format and the likely shape of
LM artifacts in the wild (reference fetches whatever the HF repo carries:
BDRC/utils.py:132-159) — round 1 supported only PROBING. This module adds
the trie family:

- :class:`KenLMTrie` — memory-mapped reader of TRIE-format binaries: a
  reverse trie over word ids (lm/trie.hh, lm/search_trie.cc design). The
  path for an n-gram (w1..wn) is unigram[w_n] -> w_{n-1} -> ... -> w_1;
  each non-unigram level is a bit-packed sorted array searched by binary
  search inside the parent's child range (ranges delimited by consecutive
  ``next`` pointers, kenlm's layout invariant).
- :func:`arpa_to_trie` — converter producing the same layout (the
  migration path and the fixture source for the equality suite). Inserts
  blank intermediate nodes (prob sentinel +inf) for n-grams whose reversed
  prefix is not itself an ARPA entry, mirroring kenlm's kBlankProb trick.

Layout implemented:

    Sanity(88B) + FixedWidthParameters(model_type=2 TRIE)
    uint64 counts[order]            (pad to 8)
    vocab:  u64 n (= counts[0]-1) + sorted u64 murmur hashes, ids = rank+1,
            <unk> = 0  (SortedVocabulary design, lm/vocab.cc)
    unigram: (counts[0]+1) x {f32 prob, f32 backoff, u64 next}
             entry i's children live at [next[i], next[i+1]) in order 2
    middle k in 2..order-1: bit-packed {word_bits, 32b prob, 32b backoff,
             next_bits} entries + one terminal entry (delimits last range)
    longest: bit-packed {word_bits, 32b prob}
    words:  null-separated vocabulary strings (id order)

Quantized / array-compressed variants (model_type 3/4/5) are rejected with
a clear message (the sibling ``.arpa`` fallback in decode.decoder covers
them).

CAVEAT (same as decode.kenlm_binary, documented there): no real
kenlm-built binary was available to test against, so foreign-binary byte
compatibility is untested; the layout follows the published kenlm trie
design, round-trips through this module are exact, and the decoder
cross-checks any binary against the sibling ``.arpa`` at load time.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path

import numpy as np

from ocr_inference_tpu_torch.decode.kenlm_binary import (
    MAGIC,
    MAGIC_PREFIX,
    _MAGIC_FIELD,
    _PARAMS_SIZE,
    _SANITY_SIZE,
    _align8,
    murmur64a,
)

MODEL_TRIE = 2
_BLANK = np.float32(np.inf)  # sentinel: traversal-only node, no ARPA entry


def _bits_for(n: int) -> int:
    """Bits needed to store values in [0, n]."""
    return max(int(n).bit_length(), 1)


class _BitReader:
    """Read fixed-width little-endian fields from a packed bit stream."""

    def __init__(self, buf, byte_offset: int, byte_length: int):
        self._data = bytes(buf[byte_offset : byte_offset + byte_length])

    def read(self, bitpos: int, nbits: int) -> int:
        byte0 = bitpos >> 3
        shift = bitpos & 7
        nbytes = (shift + nbits + 7) >> 3
        word = int.from_bytes(self._data[byte0 : byte0 + nbytes], "little")
        return (word >> shift) & ((1 << nbits) - 1)

    def read_f32(self, bitpos: int) -> float:
        raw = self.read(bitpos, 32)
        return struct.unpack("<f", struct.pack("<I", raw))[0]


class _BitWriter:
    def __init__(self):
        self._acc = 0
        self._bits = 0

    def write(self, value: int, nbits: int):
        self._acc |= (value & ((1 << nbits) - 1)) << self._bits
        self._bits += nbits

    def write_f32(self, value: float):
        (raw,) = struct.unpack("<I", struct.pack("<f", value))
        self.write(raw, 32)

    def tobytes(self) -> bytes:
        nbytes = (self._bits + 7) >> 3
        # +8 guard bytes so readers can always fetch a full window
        return self._acc.to_bytes(nbytes, "little") + b"\x00" * 8


class _Middle:
    """One bit-packed middle level (orders 2..N-1)."""

    def __init__(self, reader: _BitReader, word_bits: int, next_bits: int,
                 n_entries: int):
        self.reader = reader
        self.word_bits = word_bits
        self.next_bits = next_bits
        self.entry_bits = word_bits + 64 + next_bits
        self.n = n_entries

    def word(self, i: int) -> int:
        return self.reader.read(i * self.entry_bits, self.word_bits)

    def values(self, i: int) -> tuple[float, float]:
        base = i * self.entry_bits + self.word_bits
        return self.reader.read_f32(base), self.reader.read_f32(base + 32)

    def next_ptr(self, i: int) -> int:
        base = i * self.entry_bits + self.word_bits + 64
        return self.reader.read(base, self.next_bits)

    def find(self, lo: int, hi: int, word: int) -> int | None:
        """Binary search for ``word`` in the sorted range [lo, hi)."""
        while lo < hi:
            mid = (lo + hi) // 2
            w = self.word(mid)
            if w == word:
                return mid
            if w < word:
                lo = mid + 1
            else:
                hi = mid
        return None


class _Longest:
    """The bit-packed order-N level: {word, prob} only."""

    def __init__(self, reader: _BitReader, word_bits: int, n_entries: int):
        self.reader = reader
        self.word_bits = word_bits
        self.entry_bits = word_bits + 32
        self.n = n_entries

    def word(self, i: int) -> int:
        return self.reader.read(i * self.entry_bits, self.word_bits)

    def prob(self, i: int) -> float:
        return self.reader.read_f32(i * self.entry_bits + self.word_bits)

    def find(self, lo: int, hi: int, word: int) -> int | None:
        while lo < hi:
            mid = (lo + hi) // 2
            w = self.word(mid)
            if w == word:
                return mid
            if w < word:
                lo = mid + 1
            else:
                hi = mid
        return None


class KenLMTrie:
    """Memory-mapped TRIE-format model with the ArpaLM scoring interface
    (``score(context_tokens, token) -> log10 prob``)."""

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
                f"{path}: unsupported KenLM binary format version"
            )
        (order, _mult, model_type, has_vocab, _sv) = struct.unpack_from(
            "<B3xfi?3xI", buf, _SANITY_SIZE
        )
        if model_type != MODEL_TRIE:
            raise ValueError(
                f"{path}: model_type={model_type} is not TRIE; "
                "quantized/array tries are unsupported — use the "
                "sibling .arpa"
            )
        self.order = order
        counts = list(
            struct.unpack_from(f"<{order}Q", buf, _SANITY_SIZE + _PARAMS_SIZE)
        )
        self.counts = counts
        off = _align8(_SANITY_SIZE + _PARAMS_SIZE + 8 * order)

        # sorted vocabulary: ids = rank + 1, <unk> = 0
        (n_sorted,) = struct.unpack_from("<Q", buf, off)
        off += 8
        self._vocab_hashes = np.frombuffer(
            buf, dtype="<u8", count=n_sorted, offset=off
        )
        off += 8 * n_sorted
        n_uni = counts[0]
        word_bits = _bits_for(n_uni - 1)

        # unigram array with terminal entry
        uni = np.frombuffer(
            buf, dtype=np.uint8, count=(n_uni + 1) * 16, offset=off
        ).reshape(n_uni + 1, 16)
        self._uni_vals = uni[:, :8].copy().view("<f4").reshape(n_uni + 1, 2)
        self._uni_next = uni[:, 8:].copy().view("<u8").reshape(n_uni + 1)
        off += (n_uni + 1) * 16

        # middle levels
        self._middle: list[_Middle] = []
        for k in range(2, order):
            n_entries = counts[k - 1]
            next_count = counts[k] if k + 1 < order else counts[order - 1]
            next_bits = _bits_for(next_count + n_entries + 1)
            entry_bits = word_bits + 64 + next_bits
            nbytes = ((n_entries + 1) * entry_bits + 7) // 8 + 8
            self._middle.append(
                _Middle(_BitReader(buf, off, nbytes), word_bits, next_bits,
                        n_entries)
            )
            off += _align8(nbytes)
        self._longest = None
        if order >= 2:
            n_entries = counts[order - 1]
            nbytes = (n_entries * (word_bits + 32) + 7) // 8 + 8
            self._longest = _Longest(
                _BitReader(buf, off, nbytes), word_bits, n_entries
            )
            off += _align8(nbytes)

        # trailing null-separated word strings
        self._word_ids: dict[str, int] = {}
        if has_vocab:
            idx = 0
            for wbytes in bytes(buf[off:]).split(b"\x00"):
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
        i = int(np.searchsorted(self._vocab_hashes, np.uint64(h)))
        if i < len(self._vocab_hashes) and self._vocab_hashes[i] == h:
            return i + 1
        return 0  # <unk>

    # -- trie walk --

    def _lookup(self, ids: list[int]):
        """(log10 prob, log10 backoff) of an n-gram by word ids, or None.

        Walks the reverse trie: unigram[w_n], then w_{n-1}, ..., w_1."""
        n = len(ids)
        wid = ids[-1] if ids[-1] < self.counts[0] else 0
        if n == 1:
            p, b = self._uni_vals[wid]
            if p == _BLANK:
                return None
            return float(p), float(b)
        lo, hi = int(self._uni_next[wid]), int(self._uni_next[wid + 1])
        idx = None
        for depth in range(2, n + 1):
            word = ids[n - depth]
            if depth == self.order:
                idx = self._longest.find(lo, hi, word)
                if idx is None:
                    return None
                return float(self._longest.prob(idx)), 0.0
            level = self._middle[depth - 2]
            idx = level.find(lo, hi, word)
            if idx is None:
                return None
            if depth == n:
                p, b = level.values(idx)
                if p == _BLANK:
                    return None
                return float(p), float(b)
            lo = level.next_ptr(idx)
            hi = level.next_ptr(idx + 1)
        return None

    # -- scoring (same Katz recursion as ArpaLM / KenLMBinary) --

    def score(self, context: tuple[str, ...], token: str) -> float:
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
                return backoff_sum + float(self._uni_vals[0][0])
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

def arpa_to_trie(arpa_path: str | Path, binary_path: str | Path) -> None:
    """Convert an ARPA text model into the trie binary layout above."""
    from ocr_inference_tpu_torch.decode.arpa_lm import ArpaLM

    lm = ArpaLM(arpa_path)
    order = lm.order

    # vocabulary: <unk> id 0, the rest sorted by murmur hash (rank + 1)
    unigrams = [g[0] for g in lm._table if len(g) == 1]
    others = sorted(
        (t for t in set(unigrams) if t != "<unk>"),
        key=lambda t: murmur64a(t.encode("utf-8")),
    )
    ids = {"<unk>": 0, **{t: i + 1 for i, t in enumerate(others)}}
    n_uni = len(others) + 1

    # group n-grams by reversed path: (w_n, w_{n-1}, ..., w_1)
    by_order: list[dict[tuple[int, ...], tuple[float, float]]] = [
        {} for _ in range(order + 1)
    ]
    for gram, (prob, backoff) in lm._table.items():
        path = tuple(ids.get(t, 0) for t in reversed(gram))
        by_order[len(gram)][path] = (prob, backoff)
    # blank intermediate nodes: every reversed prefix must exist so deeper
    # entries are reachable (kenlm kBlankProb design)
    for k in range(order, 2, -1):
        for path in list(by_order[k]):
            pre = path[:-1]
            if pre not in by_order[k - 1]:
                by_order[k - 1][pre] = (float(_BLANK), 0.0)

    counts = [n_uni] + [len(by_order[k]) for k in range(2, order + 1)]
    word_bits = _bits_for(n_uni - 1)

    # assign each level's entries contiguously by parent, words sorted
    children: list[dict[tuple[int, ...], list[int]]] = [
        {} for _ in range(order + 1)
    ]
    for k in range(2, order + 1):
        for path in by_order[k]:
            children[k].setdefault(path[:-1], []).append(path[-1])
        for v in children[k].values():
            v.sort()

    out = bytearray()
    magic = MAGIC + b"\x00" * (_MAGIC_FIELD - len(MAGIC))
    out += magic
    out += struct.pack("<fff", 0.0, 1.0, -0.5)
    out += struct.pack("<II", 1, 0xFFFFFFFF)
    out += b"\x00" * 4
    out += struct.pack("<Q", 1)
    assert len(out) == _SANITY_SIZE
    out += struct.pack("<B3xfi?3xI", order, 1.5, MODEL_TRIE, True, 0)
    out += struct.pack(f"<{order}Q", *counts)
    out += b"\x00" * (_align8(len(out)) - len(out))

    # sorted vocab hashes
    out += struct.pack("<Q", len(others))
    for t in others:
        out += struct.pack("<Q", murmur64a(t.encode("utf-8")))

    # walk levels, recording each path's index so parents can point at
    # children ranges; level k entries emitted in parent-index order
    path_index: list[dict[tuple[int, ...], int]] = [
        {} for _ in range(order + 1)
    ]
    ordered_paths: list[list[tuple[int, ...]]] = [[] for _ in range(order + 1)]
    # level 1 "paths" are word ids in id order
    ordered_paths[1] = [(w,) for w in range(n_uni)]
    path_index[1] = {p: i for i, p in enumerate(ordered_paths[1])}
    for k in range(2, order + 1):
        pos = 0
        for parent in ordered_paths[k - 1]:
            for w in children[k].get(parent, ()):  # sorted within parent
                path = parent + (w,)
                path_index[k][path] = pos
                ordered_paths[k].append(path)
                pos += 1

    # unigram array (+ terminal)
    uni = np.zeros((n_uni + 1, 4), "<f4")
    uni_next = np.zeros(n_uni + 1, "<u8")
    uni[0, 0] = by_order[1].get((0,), (-10.0, 0.0))[0]
    uni[0, 1] = by_order[1].get((0,), (-10.0, 0.0))[1]
    for path, (p, b) in by_order[1].items():
        uni[path[0], 0] = p
        uni[path[0], 1] = b
    if order >= 2:
        nxt = 0
        for w in range(n_uni):
            uni_next[w] = nxt
            nxt += len(children[2].get((w,), ()))
        uni_next[n_uni] = nxt
    packed_uni = bytearray()
    for i in range(n_uni + 1):
        packed_uni += struct.pack(
            "<ffQ", float(uni[i, 0]), float(uni[i, 1]), int(uni_next[i])
        )
    out += bytes(packed_uni)

    # middle levels
    for k in range(2, order):
        next_count = counts[k] if k + 1 < order else counts[order - 1]
        next_bits = _bits_for(next_count + counts[k - 1] + 1)
        w = _BitWriter()
        nxt = 0
        for path in ordered_paths[k]:
            prob, backoff = by_order[k][path]
            w.write(path[-1], word_bits)
            w.write_f32(prob)
            w.write_f32(backoff)
            w.write(nxt, next_bits)
            nxt += len(children[k + 1].get(path, ()))
        # terminal entry: word/values unused, next = end
        w.write(0, word_bits)
        w.write_f32(0.0)
        w.write_f32(0.0)
        w.write(nxt, next_bits)
        blob = w.tobytes()
        out += blob + b"\x00" * (_align8(len(blob)) - len(blob))

    # longest level
    if order >= 2:
        w = _BitWriter()
        for path in ordered_paths[order]:
            w.write(path[-1], word_bits)
            w.write_f32(by_order[order][path][0])
        blob = w.tobytes()
        out += blob + b"\x00" * (_align8(len(blob)) - len(blob))

    # trailing word strings in id order
    vocab_order = ["<unk>"] + others
    out += b"\x00".join(t.encode("utf-8") for t in vocab_order) + b"\x00"
    Path(binary_path).write_bytes(bytes(out))


def open_binary(path: str | Path):
    """Open a KenLM ``.binary`` of either supported model type.

    Dispatches on FixedWidthParameters.model_type: 0 = probing
    (decode.kenlm_binary), 2 = trie (this module). Quantized/array
    variants raise with a clear message (decode.decoder falls back to the
    sibling ``.arpa``)."""
    from ocr_inference_tpu_torch.decode.kenlm_binary import KenLMBinary

    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(_SANITY_SIZE + _PARAMS_SIZE)
    if not head.startswith(MAGIC_PREFIX):
        raise ValueError(f"{path}: not a KenLM binary (bad magic)")
    (model_type,) = struct.unpack_from("<i", head, _SANITY_SIZE + 8)
    if model_type == 0:
        return KenLMBinary(path)
    if model_type == MODEL_TRIE:
        return KenLMTrie(path)
    raise ValueError(
        f"{path}: model_type={model_type} (quantized/array trie) is "
        "unsupported — use the sibling .arpa"
    )

"""EWTS (Extended Wylie) <-> Tibetan Unicode transliteration.

Self-contained replacement for the ``pyewts`` dependency the reference uses
for recognition-output conversion and label reading (reference:
BDRC/inference.py:452, 640-649; BDRC/label_encoder.py:126-138). Implements
the EWTS syllable grammar: longest-match letter tokenization, standard
superscribed/subscribed stack tables (so "bsgrubs" needs no '+'), prefix
detection, the '.' disambiguator (g.yag vs gyag), explicit '+' stacking for
Sanskrit, vowel signs incl. long vowels and diphthongs, anusvara/visarga
marks, digits, and punctuation. Also ships botok-equivalent
``normalize_unicode`` and ``tokenize_in_stacks``.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Letter tables
# ---------------------------------------------------------------------------

# wylie consonant -> full (head) form
CONSONANTS: dict[str, str] = {
    "k": "ཀ", "kh": "ཁ", "g": "ག", "ng": "ང",
    "c": "ཅ", "ch": "ཆ", "j": "ཇ", "ny": "ཉ",
    "T": "ཊ", "Th": "ཋ", "D": "ཌ", "N": "ཎ",
    "t": "ཏ", "th": "ཐ", "d": "ད", "n": "ན",
    "p": "པ", "ph": "ཕ", "b": "བ", "m": "མ",
    "ts": "ཙ", "tsh": "ཚ", "dz": "ཛ", "w": "ཝ",
    "zh": "ཞ", "z": "ཟ", "'": "འ", "y": "ཡ",
    "r": "ར", "l": "ལ", "sh": "ཤ", "Sh": "ཥ",
    "s": "ས", "h": "ཧ",
    "R": "ཪ",
}

# full form -> subjoined form; the Unicode block offsets most by +0x50
_SUBJOIN_SPECIAL = {"ཪ": "ྼ"}

A_CHEN = "ཨ"  # base letter for bare vowels


def subjoined(full_char: str) -> str:
    if full_char in _SUBJOIN_SPECIAL:
        return _SUBJOIN_SPECIAL[full_char]
    cp = ord(full_char)
    if 0x0F40 <= cp <= 0x0F68:
        return chr(cp + 0x50)
    return full_char


# wylie vowel -> combining sign(s); "a" is inherent (empty)
VOWELS: dict[str, str] = {
    "a": "", "i": "ི", "u": "ུ", "e": "ེ", "o": "ོ",
    "A": "ཱ", "I": "ཱི", "U": "ཱུ",
    "-i": "ྀ", "-I": "ཱྀ",
    "ai": "ཻ", "au": "ཽ",
}

# standalone marks (post-vowel)
MARKS: dict[str, str] = {
    "M": "ཾ",   # anusvara
    "H": "ཿ",   # visarga
    "~M": "ྃ",  # sna ldan
    "~M`": "ྂ",
    "?": "྄",   # virama
    "&": "྅",   # paluta (BDRC escape target, label_encoder.py:36)
}

PUNCT: dict[str, str] = {
    " ": "་",   # tsheg
    "*": "༌",   # no-break tsheg
    "/": "།",   # shad
    "//": "༎",  # nyis shad
    ";": "༏",
    "|": "༑",
    "!": "༈",
    ":": "༔",
    "@": "༄",
    "#": "༅",
    "$": "༆",
    "%": "༇",
    "=": "༴",
    "<": "༺",
    ">": "༻",
    "(": "༼",
    ")": "༽",
    "_": " ",   # EWTS underscore = real space
}

DIGITS = {str(i): chr(0x0F20 + i) for i in range(10)}

# ---------------------------------------------------------------------------
# Standard (plus-less) stack tables
# ---------------------------------------------------------------------------

_SUPER = {
    "r": ["k", "g", "ng", "j", "ny", "t", "d", "n", "b", "m", "ts", "dz"],
    "l": ["k", "g", "ng", "c", "j", "t", "d", "p", "b", "h"],
    "s": ["k", "g", "ng", "ny", "t", "d", "n", "p", "b", "m", "ts"],
}
_SUB = {
    "y": ["k", "kh", "g", "p", "ph", "b", "m"],
    "r": ["k", "kh", "g", "t", "th", "d", "n", "p", "ph", "b", "m", "sh",
          "s", "h"],
    "l": ["k", "g", "b", "r", "s", "z"],
    "w": ["k", "kh", "g", "c", "ny", "t", "d", "ts", "tsh", "zh", "z", "r",
          "l", "sh", "s", "h"],
}
_TRIPLES = [
    "rky", "rgy", "rmy", "rgw", "rtsw",
    "sky", "sgy", "spy", "sby", "smy",
    "skr", "sgr", "snr", "spr", "sbr", "smr",
    "grw", "drw", "phyw",
]

PREFIXES = ["g", "d", "b", "m", "'"]
SUFFIXES = ["g", "ng", "d", "n", "b", "m", "'", "r", "l", "s"]
SUFFIX2 = ["s", "d"]


def _tokenize_consonant_run(s: str) -> list[str] | None:
    """Greedy longest-match split of a consonant-only wylie string."""
    out = []
    i = 0
    names = sorted(CONSONANTS, key=len, reverse=True)
    while i < len(s):
        for n in names:
            if s.startswith(n, i):
                out.append(n)
                i += len(n)
                break
        else:
            return None
    return out


def _build_stacks() -> set[tuple[str, ...]]:
    stacks: set[tuple[str, ...]] = set()
    for head, roots in _SUPER.items():
        for r in roots:
            stacks.add((head, r))
    for sub, bases in _SUB.items():
        for b in bases:
            stacks.add((b, sub))
    for t in _TRIPLES:
        toks = _tokenize_consonant_run(t)
        if toks:
            stacks.add(tuple(toks))
    stacks.add(("l", "h"))  # lha
    return stacks


STANDARD_STACKS = _build_stacks()


def is_standard_stack(tokens) -> bool:
    return tuple(tokens) in STANDARD_STACKS


# ---------------------------------------------------------------------------
# Wylie -> Unicode
# ---------------------------------------------------------------------------

_TOKENS = sorted(
    set(list(CONSONANTS) + list(VOWELS) + list(MARKS) + ["+", "."]),
    key=len,
    reverse=True,
)


def _next_token(s: str, i: int) -> str | None:
    for t in _TOKENS:
        if s.startswith(t, i):
            return t
    return None


def _split_onset(cluster: list[str]) -> tuple[str | None, list[str]]:
    """Split the first (onset) consonant cluster into (prefix, stack)."""
    if len(cluster) == 1:
        return None, cluster
    if is_standard_stack(cluster):
        return None, cluster
    if cluster[0] in PREFIXES:
        rest = cluster[1:]
        if len(rest) == 1 or is_standard_stack(rest):
            return cluster[0], rest
    return None, cluster  # undecomposable: render as one stack


def _render_cluster(
    cluster: list[str], vowel: str | None, is_first: bool, plus_joined: bool
) -> str:
    out: list[str] = []
    if not cluster:
        if vowel is not None:
            out.append(A_CHEN)
    elif plus_joined or (is_first and len(cluster) > 1):
        if is_first and not plus_joined:
            prefix, stack = _split_onset(cluster)
        else:
            prefix, stack = None, cluster
        if prefix:
            out.append(CONSONANTS[prefix])
        out.append(CONSONANTS[stack[0]])
        for tok in stack[1:]:
            out.append(subjoined(CONSONANTS[tok]))
    else:
        # suffix chain (or single onset): every consonant in full form
        for tok in cluster:
            out.append(CONSONANTS[tok])
    if vowel:
        out.append(VOWELS[vowel])
    return "".join(out)


def _syllable_to_unicode(syl: str) -> str:
    result: list[str] = []
    cluster: list[str] = []
    first_unit = True
    saw_plus = False
    i = 0

    def flush(vowel: str | None):
        nonlocal cluster, first_unit, saw_plus
        if cluster or vowel is not None:
            result.append(_render_cluster(cluster, vowel, first_unit, saw_plus))
            first_unit = False
        cluster = []
        saw_plus = False

    while i < len(syl):
        ch = syl[i]
        if ch in DIGITS:
            flush(None)
            result.append(DIGITS[ch])
            first_unit = False
            i += 1
            continue
        tok = _next_token(syl, i)
        if tok is None:
            flush(None)
            result.append(ch)  # unknown char passthrough
            i += 1
            continue
        i += len(tok)
        if tok == ".":
            flush(None)  # barrier: pending consonants render standalone
        elif tok == "+":
            saw_plus = True
        elif tok in MARKS:
            flush(None)
            result.append(MARKS[tok])
        elif tok in VOWELS:
            flush(tok)
        else:  # consonant
            cluster.append(tok)
    flush(None)
    return "".join(result)


def to_unicode(wylie: str) -> str:
    """EWTS -> Tibetan Unicode (pyewts.toUnicode equivalent)."""
    out = []
    i = 0
    n = len(wylie)
    while i < n:
        ch = wylie[i]
        if ch == "/":
            if wylie.startswith("//", i):
                out.append(PUNCT["//"])
                i += 2
            else:
                out.append(PUNCT["/"])
                i += 1
            continue
        if ch in PUNCT:
            out.append(PUNCT[ch])
            i += 1
            continue
        if ch == "\n":
            out.append("\n")
            i += 1
            continue
        j = i
        while j < n and wylie[j] not in PUNCT and wylie[j] != "\n":
            j += 1
        out.append(_syllable_to_unicode(wylie[i:j]))
        i = j
    return "".join(out)


# ---------------------------------------------------------------------------
# Unicode -> Wylie
# ---------------------------------------------------------------------------

_FULL_TO_WYLIE = {v: k for k, v in CONSONANTS.items()}
_FULL_TO_WYLIE[A_CHEN] = "a"
_SUB_TO_WYLIE = {subjoined(v): k for k, v in CONSONANTS.items()}
_SUB_TO_WYLIE["ྸ"] = "a"
_VOWEL_SIGNS = {
    "ཱ": "A", "ི": "i", "ུ": "u", "ེ": "e", "ོ": "o",
    "ཻ": "ai", "ཽ": "au", "ྀ": "-i",
}
_MARK_TO_WYLIE = {v: k for k, v in MARKS.items()}
_PUNCT_TO_WYLIE = {v: k for k, v in PUNCT.items() if v != " "}
_PUNCT_TO_WYLIE["་"] = " "
_DIGIT_TO_WYLIE = {v: k for k, v in DIGITS.items()}


class _Stack:
    __slots__ = ("cons", "vowels", "marks")

    def __init__(self):
        self.cons: list[str] = []   # wylie tokens, head first
        self.vowels: list[str] = []
        self.marks: list[str] = []

    @property
    def has_vowel_sign(self) -> bool:
        return bool(self.vowels)


# prefix validity (classical orthography), used for root disambiguation in
# vowel-less syllables (the dag/dga' problem) and to tell Sanskrit clusters
# (badzra) apart from prefixed native stacks (brtags)
_PREFIX_TABLE = {
    "g": ["c", "ny", "t", "d", "n", "ts", "zh", "z", "y", "sh", "s"],
    "d": ["k", "g", "ng", "p", "b", "m",
          "ky", "gy", "py", "by", "my", "kr", "gr", "pr", "br"],
    "b": ["k", "g", "c", "t", "d", "ts", "zh", "z", "sh", "s",
          "ky", "gy", "kr", "gr", "kl", "zl", "rl", "sl"],
    "m": ["kh", "g", "ng", "ch", "j", "ny", "th", "d", "n", "tsh", "dz",
          "khy", "gy", "khr", "gr"],
    "'": ["kh", "g", "ch", "j", "th", "d", "ph", "b", "tsh", "dz",
          "khy", "gy", "phy", "by", "khr", "gr", "dr", "phr", "br"],
}


def _valid_prefix_pair(prefix: str, root: str) -> bool:
    if root in _PREFIX_TABLE.get(prefix, []):
        return True
    # b/d/m/' also prefix any standard superscribed stack (bsgrubs, brtags)
    if prefix == "b" and root and root[0] in ("r", "l", "s"):
        return True
    return False


def _syllable_stacks(chars: str) -> list[_Stack]:
    stacks: list[_Stack] = []

    def ensure() -> _Stack:
        if not stacks:
            stacks.append(_Stack())
        return stacks[-1]

    for ch in chars:
        if ch in _FULL_TO_WYLIE:
            st = _Stack()
            st.cons.append(_FULL_TO_WYLIE[ch])
            stacks.append(st)
        elif ch in _SUB_TO_WYLIE:
            ensure().cons.append(_SUB_TO_WYLIE[ch])
        elif ch in _VOWEL_SIGNS:
            ensure().vowels.append(_VOWEL_SIGNS[ch])
        elif ch in _MARK_TO_WYLIE:
            ensure().marks.append(_MARK_TO_WYLIE[ch])
        else:
            st = _Stack()
            # unknown Tibetan-block signs surface as \uXXXX escapes, which is
            # what the BDRC label postprocessing expects to rewrite
            # (reference: BDRC/label_encoder.py:36-43); anything else passes
            # through verbatim
            if 0x0F00 <= ord(ch) <= 0x0FFF:
                st.cons.append("\\u%04x" % ord(ch))
            else:
                st.cons.append(ch)
            stacks.append(st)
    return [s for s in stacks if s.cons or s.vowels or s.marks]


def _vowel_string(vowels: list[str]) -> str:
    if not vowels:
        return "a"
    combo = "".join(vowels)
    merged = {"Ai": "I", "Au": "U", "A-i": "-I"}
    return merged.get(combo, combo)


def _stack_body(cons: list[str]) -> str:
    if not cons:
        return ""
    if len(cons) == 1 or is_standard_stack(cons):
        return "".join(cons)
    return "+".join(cons)


def _is_letter_stack(st: _Stack) -> bool:
    return bool(st.cons) and (st.cons[0] in CONSONANTS or st.cons[0] == "a")


def _find_root(stacks: list[_Stack]) -> int:
    for idx, st in enumerate(stacks):
        if not _is_letter_stack(st):
            continue
        if len(st.cons) > 1 or st.has_vowel_sign:
            # a vowel-bearing final achung is the genitive/terminative
            # suffix (ba'i, ba'o), not the root
            if (
                idx > 0
                and idx == len(stacks) - 1
                and st.cons == ["'"]
                and st.has_vowel_sign
            ):
                continue
            # a multi-consonant stack is the root only if what precedes it
            # can legally prefix it; otherwise (Sanskrit: badzra) the first
            # letter is the root
            if (
                len(st.cons) > 1
                and idx == 1
                and len(stacks[0].cons) == 1
                and not stacks[0].has_vowel_sign
                and _is_letter_stack(stacks[0])
                and not _valid_prefix_pair(
                    stacks[0].cons[0], "".join(st.cons)
                )
            ):
                return 0
            return idx
    n = len(stacks)
    if n == 3:
        c = [s.cons[0] if s.cons else "" for s in stacks]
        if _valid_prefix_pair(c[0], c[1]) and c[2] in SUFFIXES:
            return 1
        return 0
    if n == 4:
        return 1
    return 0


def _syllable_to_wylie(chars: str) -> str:
    stacks = _syllable_stacks(chars)
    if not stacks:
        return ""
    root = _find_root(stacks)
    out: list[str] = []
    for idx, st in enumerate(stacks):
        if not st.cons:
            out.append(_vowel_string(st.vowels) if st.vowels else "")
            out.extend(st.marks)
            continue
        if not _is_letter_stack(st):
            out.append("".join(st.cons))
            out.extend(st.marks)
            continue
        if idx == root:
            body = _stack_body(st.cons)
            if st.cons == ["a"]:
                body = ""  # A chen: the vowel string carries the letter
            out.append(body + _vowel_string(st.vowels))
            out.extend(st.marks)
        elif idx < root:
            out.append(st.cons[0])
            nxt = stacks[idx + 1]
            if (
                len(nxt.cons) == 1
                and is_standard_stack((st.cons[0], nxt.cons[0]))
            ):
                out.append(".")  # g.yag-style disambiguation
        else:
            # suffix chain; a vowel-bearing suffix unit (e.g. 'i) keeps its
            # vowel, and a post-root stack that is not a plain suffix letter
            # (Sanskrit: the dzra of badzra) carries the inherent a
            if st.has_vowel_sign:
                out.append(_stack_body(st.cons) + _vowel_string(st.vowels))
            elif len(st.cons) > 1 or st.cons[0] not in SUFFIXES:
                out.append(_stack_body(st.cons) + _vowel_string([]))
            else:
                out.append(_stack_body(st.cons))
            out.extend(st.marks)
    return "".join(out)


def to_wylie(unicode_text: str) -> str:
    """Tibetan Unicode -> EWTS (pyewts.toWylie equivalent)."""
    text = normalize_unicode(unicode_text)
    out: list[str] = []
    syl: list[str] = []

    def flush():
        if syl:
            out.append(_syllable_to_wylie("".join(syl)))
            syl.clear()

    for ch in text:
        if ch in _PUNCT_TO_WYLIE:
            flush()
            out.append(_PUNCT_TO_WYLIE[ch])
        elif ch in _DIGIT_TO_WYLIE:
            flush()
            out.append(_DIGIT_TO_WYLIE[ch])
        elif ch == " " or ch == "\n":
            flush()
            out.append("_" if ch == " " else ch)
        elif 0x0F00 <= ord(ch) <= 0x0FFF:
            syl.append(ch)
        else:
            flush()
            out.append(ch)
    flush()
    return "".join(out)


# ---------------------------------------------------------------------------
# Normalization + stack tokenization (botok-equivalent subset)
# ---------------------------------------------------------------------------

_DECOMPOSE = {
    "\u0F00": "\u0F68\u0F7C\u0F7E",  # oM ligature
    "\u0F73": "\u0F71\u0F72",  # ii
    "\u0F75": "\u0F71\u0F74",  # uu
    "\u0F76": "\u0FB2\u0F80",  # vocalic r
    "\u0F77": "\u0FB2\u0F71\u0F80",
    "\u0F78": "\u0FB3\u0F80",  # vocalic l
    "\u0F79": "\u0FB3\u0F71\u0F80",
    "\u0F81": "\u0F71\u0F80",
    "\u0F43": "\u0F42\u0FB7",  # gha
    "\u0F4D": "\u0F4C\u0FB7",  # Dha
    "\u0F52": "\u0F51\u0FB7",  # dha
    "\u0F57": "\u0F56\u0FB7",  # bha
    "\u0F5C": "\u0F5B\u0FB7",  # dzha
    "\u0F69": "\u0F40\u0FB5",  # kSha
    "\u0F93": "\u0F92\u0FB7",
    "\u0F9D": "\u0F9C\u0FB7",
    "\u0FA2": "\u0FA1\u0FB7",
    "\u0FA7": "\u0FA6\u0FB7",
    "\u0FAC": "\u0FAB\u0FB7",
    "\u0FB9": "\u0F90\u0FB5",
}


def normalize_unicode(text: str) -> str:
    """Decompose precomposed Tibetan vowels/aspirates
    (botok.normalize_unicode-equivalent subset; reference usage:
    BDRC/label_encoder.py:108-117). The triangle-tsheg normalization the
    reference applies separately lives in
    ``text.encoders.preprocess_unicode``."""
    return "".join(_DECOMPOSE.get(ch, ch) for ch in text)


_COMBINING_RANGES = (
    (0x0F39, 0x0F39),
    (0x0F71, 0x0F84),
    (0x0F86, 0x0F87),
    (0x0F90, 0x0FBC),
)


def _is_combining(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _COMBINING_RANGES)


def tokenize_in_stacks(text: str) -> list[str]:
    """Split Tibetan Unicode into visual stacks (botok.tokenize_in_stacks
    equivalent; reference usage: BDRC/label_encoder.py:117)."""
    stacks: list[str] = []
    for ch in text:
        if stacks and _is_combining(ch):
            stacks[-1] += ch
        else:
            stacks.append(ch)
    return stacks

"""The port's n-gram LM code against the JAX package's: the Python and C++
ARPA scorers on every n-gram of the eval LM and on backoff and OOV probes,
the Witten-Bell ARPA builder, the KenLM probing and trie binaries, the
decoder's LM loading with its binary cross-check and ``.arpa`` fallback,
and the asset helpers."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from ocr_inference_tpu.core import assets as jassets
from ocr_inference_tpu.core.data import KenLMConfig as JaxKenLMConfig
from ocr_inference_tpu.decode import decoder as jdecoder
from ocr_inference_tpu.decode.arpa_lm import ArpaLM as JaxArpaLM
from ocr_inference_tpu.decode.kenlm_binary import (
    arpa_to_binary as jax_arpa_to_binary,
)
from ocr_inference_tpu.decode.kenlm_trie import (
    arpa_to_trie as jax_arpa_to_trie,
    open_binary as jax_open_binary,
)
from ocr_inference_tpu.decode.ngram_builder import (
    build_char_arpa as jax_build_char_arpa,
)
from ocr_inference_tpu.eval.synthetic import (
    WYLIE_CHARSET_FULL,
    sample_tokens as jax_sample_tokens,
)
from ocr_inference_tpu.native import NativeArpaLM as JaxNativeArpaLM
from ocr_inference_tpu_torch.core import assets
from ocr_inference_tpu_torch.core.data import KenLMConfig
from ocr_inference_tpu_torch.decode import decoder
from ocr_inference_tpu_torch.decode.arpa_lm import ArpaLM
from ocr_inference_tpu_torch.decode.kenlm_binary import (
    KenLMBinary,
    arpa_to_binary,
)
from ocr_inference_tpu_torch.decode.kenlm_trie import (
    KenLMTrie,
    arpa_to_trie,
    open_binary,
)
from ocr_inference_tpu_torch.decode.ngram_builder import build_char_arpa
from ocr_inference_tpu_torch.eval.synthetic import sample_tokens
from ocr_inference_tpu_torch.native import NativeArpaLM

REPO = Path(__file__).resolve().parents[1]
LM = REPO / "artifacts" / "full77f" / "lm.arpa"
# the eval CLI's LM corpus (cli/selftrain_cli.py:386-406 at its defaults)
LM_SEED, LM_LINES, LM_ORDER = 5 + 77, 500, 3


def _probes(lm) -> list[tuple[tuple[str, ...], str]]:
    """Every n-gram of the table as (context, token), the same grams
    extended by an unseen token and by an OOV context (backoff paths), and
    OOV tokens alone and after every unigram."""
    grams = list(lm._table)
    out = [(g[:-1], g[-1]) for g in grams]
    out += [(g, "\x00unseen\x00") for g in grams[::7]]
    out += [(("\x00oov\x00",) + g[:-1], g[-1]) for g in grams[::5]]
    out += [((), "\x00oov\x00")]
    out += [(g, "\x00oov\x00") for g in grams if len(g) == 1]
    # contexts longer than the order are cut to its last order - 1 tokens
    out += [(("a", "b") + g[:-1], g[-1]) for g in grams[::11]]
    return out


@pytest.fixture(scope="module")
def eval_lm():
    return ArpaLM(LM), JaxArpaLM(LM)


def test_python_scorer_equals_jax_on_every_ngram(eval_lm):
    ours, theirs = eval_lm
    assert ours.order == theirs.order == 3
    assert ours._table == theirs._table
    for ctx, tok in _probes(theirs):
        assert ours.score(ctx, tok) == theirs.score(ctx, tok), (ctx, tok)


def test_native_scorer_equals_jax_native_on_every_ngram(eval_lm):
    ours, theirs = NativeArpaLM(LM), JaxNativeArpaLM(LM)
    assert ours.order == theirs.order == 3
    for ctx, tok in _probes(eval_lm[1]):
        assert ours.score(ctx, tok) == theirs.score(ctx, tok), (ctx, tok)


def test_native_and_python_scorers_differ_only_by_float32_tables(eval_lm):
    """The C++ tables are float32, the Python ones float64: each looked-up
    value moves by at most half a float32 ulp, and a score sums at most
    ``order`` of them."""
    native, py = NativeArpaLM(LM), eval_lm[0]
    worst = 0.0
    for ctx, tok in _probes(py):
        a, b = native.score(ctx, tok), py.score(ctx, tok)
        bound = py.order * max(abs(b), 1.0) * 2.0 ** -24
        assert abs(a - b) <= bound, (ctx, tok, a, b)
        worst = max(worst, abs(a - b))
    assert 0.0 < worst < 1e-6


@pytest.mark.parametrize("add_blank", [True, False])
def test_score_fns_equal_jax(eval_lm, add_blank):
    """make_score_fn over vocab ids (the +1 blank shift), both scorers."""
    charset = list(WYLIE_CHARSET_FULL)
    shift = 1 if add_blank else 0
    rng = np.random.RandomState(3)
    pairs = [
        (tuple(int(v) for v in rng.randint(shift, 77 + shift, size=n)),
         int(rng.randint(shift, 77 + shift)))
        for n in (0, 1, 2, 3, 5) for _ in range(40)
    ]
    for ours, theirs in ((eval_lm[0], eval_lm[1]),
                         (NativeArpaLM(LM), JaxNativeArpaLM(LM))):
        f = ours.make_score_fn(charset, add_blank)
        g = theirs.make_score_fn(charset, add_blank)
        for prefix, nxt in pairs:
            assert f(prefix, nxt) == g(prefix, nxt), (prefix, nxt)


def test_builder_writes_the_eval_lm_byte_for_byte(tmp_path):
    """The eval CLI's corpus through the port's builder and sampler gives
    artifacts/full77f/lm.arpa, the LM of EVAL_r05."""
    rng = np.random.RandomState(LM_SEED)
    corpus = [" ".join(sample_tokens(rng, WYLIE_CHARSET_FULL))
              for _ in range(LM_LINES)]
    jrng = np.random.RandomState(LM_SEED)
    assert corpus[:20] == [" ".join(jax_sample_tokens(jrng,
                                                      WYLIE_CHARSET_FULL))
                           for _ in range(20)]
    out = build_char_arpa(corpus, tmp_path / "lm.arpa", order=LM_ORDER,
                          tokens=True)
    assert out.read_bytes() == LM.read_bytes()


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("tokens", [False, True])
def test_builder_bytes_equal_jax(tmp_path, order, tokens):
    rng = np.random.RandomState(order)
    if tokens:
        corpus = [" ".join(sample_tokens(rng, WYLIE_CHARSET_FULL[:12]))
                  for _ in range(30)]
    else:
        corpus = ["".join(rng.choice(list("abcd e"), size=rng.randint(1, 12)))
                  for _ in range(30)] + [""]
    ours = build_char_arpa(corpus, tmp_path / "ours.arpa", order=order,
                           tokens=tokens)
    theirs = jax_build_char_arpa(corpus, tmp_path / "jax.arpa", order=order,
                                 tokens=tokens)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.fixture(scope="module")
def small_arpa(tmp_path_factory):
    """An order-4 token LM small enough for the binary writers."""
    rng = np.random.RandomState(11)
    corpus = [" ".join(sample_tokens(rng, WYLIE_CHARSET_FULL[:20]))
              for _ in range(60)]
    return build_char_arpa(corpus, tmp_path_factory.mktemp("lm") / "lm.arpa",
                           order=4, tokens=True)


@pytest.mark.parametrize("arpa", ["small", "eval"])
@pytest.mark.parametrize("kind", ["probing", "trie"])
def test_binary_writers_bytes_equal_jax(tmp_path, small_arpa, arpa, kind):
    src = small_arpa if arpa == "small" else LM
    ours, theirs = tmp_path / "ours.binary", tmp_path / "jax.binary"
    if kind == "probing":
        arpa_to_binary(src, ours)
        jax_arpa_to_binary(src, theirs)
    else:
        arpa_to_trie(src, ours)
        jax_arpa_to_trie(src, theirs)
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("kind", ["probing", "trie"])
def test_each_package_reads_the_others_binary(tmp_path, small_arpa, kind):
    write = {"probing": (arpa_to_binary, jax_arpa_to_binary),
             "trie": (arpa_to_trie, jax_arpa_to_trie)}[kind]
    ours_path, jax_path = tmp_path / "ours.binary", tmp_path / "jax.binary"
    write[0](small_arpa, ours_path)
    write[1](small_arpa, jax_path)
    ours = open_binary(jax_path)
    theirs = jax_open_binary(ours_path)
    assert isinstance(ours, KenLMBinary if kind == "probing" else KenLMTrie)
    ref = ArpaLM(small_arpa)
    probes = _probes(ref)
    for ctx, tok in probes:
        a, b = ours.score(ctx, tok), theirs.score(ctx, tok)
        assert a == b, (ctx, tok)
        assert a == pytest.approx(ref.score(ctx, tok), abs=1e-5)


def _corrupt(path: Path) -> None:
    """Flip the sign bit of float32 log-probs past the header: the file
    still parses, but its scores leave the .arpa's."""
    raw = bytearray(path.read_bytes())
    for off in range(len(raw) // 2, len(raw) - 4, 16):
        raw[off + 3] ^= 0x80
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("kind", ["probing", "trie"])
@pytest.mark.parametrize("damage", ["corrupt", "truncate"])
@pytest.mark.parametrize("sibling", [True, False])
def test_load_lm_crosscheck_and_fallback_match_jax(tmp_path, small_arpa,
                                                   capsys, kind, damage,
                                                   sibling):
    """A damaged ``.binary`` configured as the LM gives the JAX outcome:
    with its sibling ``.arpa`` both packages score with the sibling;
    without it, a binary that still opens is kept (nothing can check it)
    and one that does not open leaves both with no LM."""
    binary = tmp_path / "lm.binary"
    (arpa_to_binary if kind == "probing" else arpa_to_trie)(small_arpa,
                                                            binary)
    if damage == "corrupt":
        _corrupt(binary)
    else:
        binary.write_bytes(binary.read_bytes()[: len(binary.read_bytes())
                                               // 3])
    if sibling:
        shutil.copy2(small_arpa, tmp_path / "lm.arpa")
    charset = list(WYLIE_CHARSET_FULL)
    ours = decoder.CTCDecoder(charset, True,
                              KenLMConfig(str(binary), str(binary), None))
    out = capsys.readouterr().err
    theirs = jdecoder.CTCDecoder(charset, True,
                                 JaxKenLMConfig(str(binary), str(binary),
                                                None))
    jout = capsys.readouterr().err
    assert ours.has_lm == theirs.has_lm
    assert type(ours._lm).__name__ == type(theirs._lm).__name__
    for msg in ("KenLM binary unusable", "KenLM disabled"):
        assert (msg in out) == (msg in jout), (out, jout)
    if sibling:
        assert "KenLM binary unusable" in out
        assert isinstance(ours._lm, NativeArpaLM)
    if damage == "corrupt":
        assert ours.has_lm  # parses: kept, or replaced by the sibling
    if not ours.has_lm:
        assert "KenLM disabled" in out
        return
    for ctx, tok in _probes(ArpaLM(small_arpa))[::3]:
        try:
            want = theirs._lm.score(ctx, tok)
        except Exception as e:  # a truncated table may fail to score
            with pytest.raises(type(e)):
                ours._lm.score(ctx, tok)
            continue
        assert ours._lm.score(ctx, tok) == want, (ctx, tok)


def test_intact_binary_loads_as_itself(tmp_path, small_arpa):
    binary = tmp_path / "lm.binary"
    arpa_to_trie(small_arpa, binary)
    shutil.copy2(small_arpa, tmp_path / "lm.arpa")
    dec = decoder.CTCDecoder(list(WYLIE_CHARSET_FULL), True,
                             KenLMConfig(str(binary), str(binary), None))
    assert isinstance(dec._lm, KenLMTrie)
    assert decoder._crosscheck_binary(dec._lm, tmp_path / "lm.arpa")


def test_missing_or_empty_arpa_disables_the_lm(tmp_path, capsys):
    charset = list(WYLIE_CHARSET_FULL)
    empty = tmp_path / "empty.arpa"
    empty.write_text("not an arpa file\n")
    for path in (tmp_path / "missing.arpa", empty):
        dec = decoder.CTCDecoder(charset, True,
                                 KenLMConfig(str(path), str(path), None))
        assert not dec.has_lm
    assert capsys.readouterr().err.count("KenLM disabled") == 2
    dec = decoder.CTCDecoder(charset, True, KenLMConfig(str(LM), str(LM),
                                                        None))
    assert dec.has_lm and isinstance(dec._lm, NativeArpaLM)


def test_scorer_build_failure_reaches_the_caller(monkeypatch):
    """No fall-through to the Python scorer: a failed g++ build raises out
    of the decoder instead of turning the LM off."""
    from ocr_inference_tpu_torch import native

    def fail(source="geometry.cpp"):
        raise RuntimeError(f"g++ failed on {source}")

    monkeypatch.setattr(native, "_ARPA_LIB", None)
    monkeypatch.setattr(native, "build_library", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on arpa_lm.cpp"):
        decoder.CTCDecoder(list(WYLIE_CHARSET_FULL), True,
                           KenLMConfig(str(LM), str(LM), None))


def _no_gxx(*args, **kwargs):
    raise FileNotFoundError(2, "No such file or directory", "g++")


def _unloadable(path, *args, **kwargs):
    raise OSError(f"{path}: invalid ELF header")


def _unwritable(self, *args, **kwargs):
    raise PermissionError(13, "Permission denied", str(self))


@pytest.mark.parametrize("where, target, broken", [
    ("no g++ on PATH", "subprocess.run", _no_gxx),
    ("a library that does not load", "ctypes.CDLL", _unloadable),
    ("a build directory it cannot write", "pathlib.Path.mkdir", _unwritable),
])
def test_scorer_os_errors_reach_the_caller(monkeypatch, tmp_path, where,
                                           target, broken):
    """The OSErrors of building or loading the scorer are the program's,
    not the LM file's: each raises out of the decoder as RuntimeError
    instead of being printed as "KenLM disabled"."""
    from ocr_inference_tpu_torch import native

    monkeypatch.setattr(native, "_ARPA_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(target, broken)
    with pytest.raises(RuntimeError, match="arpa_lm.cpp") as info:
        decoder.CTCDecoder(list(WYLIE_CHARSET_FULL), True,
                           KenLMConfig(str(LM), str(LM), None))
    assert isinstance(info.value.__cause__, OSError), where


def test_kenlm_config_helpers_equal_jax():
    ours = assets.get_kenlm_config("lm.binary", LM)
    theirs = jassets.get_kenlm_config("lm.binary", LM)
    assert ours.unigrams == theirs.unigrams
    assert len(ours.unigrams) == 80
    assert (ours.kenlm_file, ours.arpa_file, ours.alpha, ours.beta) == \
        (theirs.kenlm_file, theirs.arpa_file, theirs.alpha, theirs.beta)

"""The port's tokenizer (``tpu_llama_torch.io.tokenizer``) and native BPE
encoder (``io.fast_bpe``) against the JAX package's: the same token ids
over ASCII, merges, ties, duplicate vocab entries, astral and combining
characters; unknown characters raise in both; ``save`` writes the same
bytes and each package loads the other's file.  Exact: the encoders are
integer and string code."""

import pytest

from tpu_llama.io import tokenizer as jtok
from tpu_llama_torch.io import fast_bpe
from tpu_llama_torch.io import tokenizer as ttok

TEXTS = ["Once upon a time", "once", "on", "o", "", "time after time", "aaa bbb",
         "Once upon a time, once upon a time", "x" * 200, "abcd", "�", " a",
         "café \U0001F600!", "é́", "\U0001F600\U0001F600 \U0001F600"]


def _pair(extra=()):
    return jtok.make_byte_tokenizer(extra), ttok.make_byte_tokenizer(extra)


def _unicode_pair():
    """Byte tokenizers with non-ASCII seeds and merges: a precomposed and a
    combining accent, an emoji's two UTF-16 surrogate halves (no utf-8 form:
    their stored bytes are the surrogatepass ones) and merges over them."""
    hi, lo = "\ud83d", "\ude00"
    extra = [("é", -1.0), ("́", -1.5), ("é", -2.0), (hi, -3.0), (lo, -3.0),
             (hi + lo, -2.5), (hi + lo + hi + lo, -2.6), ("caf", -4.0), ("ca", -4.5),
             ("é́", -2.0), (" ", -9.0), ("!", -9.0)]
    out = []
    for mod in (jtok, ttok):
        base = mod.make_byte_tokenizer()
        vocab = base.vocab + [t for t, _ in extra]
        scores = base.scores + [s for _, s in extra]
        raws = base.raw_bytes + [t.encode("utf-8", errors="surrogatepass") for t, _ in extra]
        out.append(mod.Tokenizer(vocab, scores, raw_bytes=raws))
    return out


def _encode(tok, text, py=False):
    try:
        return tok._encode_py(text) if py else tok.encode(text)
    except ValueError as e:
        return ("raises", str(e))


@pytest.mark.parametrize("which", ["tiny", "ties", "unicode", "bytes"])
def test_encode_equals_jax(which, tiny_tokenizer):
    if which == "tiny":
        merges = list(zip(tiny_tokenizer.vocab[259:], tiny_tokenizer.scores[259:]))
        j, t = _pair(merges)
        assert j.vocab == tiny_tokenizer.vocab
    elif which == "ties":  # equal scores: the earlier pair merges first
        j, t = _pair([("ab", -1.0), ("cd", -1.0), ("bc", -1.0), ("abcd", -1.0), (" a", -1.0),
                      ("aa", -2.0), ("aaa", -2.0)])
    elif which == "unicode":
        j, t = _unicode_pair()
    else:  # every raw byte 0x80-0xFF decodes to U+FFFD: duplicates -> the first id
        j, t = _pair()
        assert t.encode("�") == [3 + 0x80]
    for text in TEXTS:
        want = _encode(j, text, py=True)
        assert _encode(t, text) == want, text
        assert _encode(t, text, py=True) == want, text
        if not isinstance(want, tuple):
            assert t.encode(text, bos=True, eos=True) == [ttok.BOS, *want, ttok.EOS]
    if which == "unicode":
        pair = "\ud83d\ude00"  # one emoji's UTF-16 units, merged
        assert _encode(t, "\U0001F600\U0001F600") == [t.vocab.index(pair + pair)]
        assert _encode(t, "é́") == [t.vocab.index("é́")]


def test_unknown_characters_raise_in_both(tiny_tokenizer):
    j, t = _pair(list(zip(tiny_tokenizer.vocab[259:], tiny_tokenizer.scores[259:])))
    for text in ["\U0001F600", "ok é", "中"]:
        for tok in (j, t):
            with pytest.raises(ValueError, match="not found in vocab"):
                tok.encode(text)
        with pytest.raises(ValueError, match="not found in vocab"):
            t._encode_py(text)


def test_decode_bos_space_strip(tiny_tokenizer):
    j, t = _pair(list(zip(tiny_tokenizer.vocab[259:], tiny_tokenizer.scores[259:])))
    sp = t.vocab.index(" a")
    assert t.decode_token(sp, prev_token=ttok.BOS) == "a"
    assert t.decode_token(sp, prev_token=5) == " a"
    ids = t.encode("Once upon a time")
    for prev in (ttok.BOS, 0, 7):
        assert t.decode(ids, prev_token=prev) == j.decode(ids, prev_token=prev)
    assert (ttok.BOS, ttok.EOS) == (jtok.BOS, jtok.EOS)


@pytest.mark.parametrize("which", ["tiny", "unicode"])
def test_save_bytes_and_cross_load(which, tmp_path, tiny_tokenizer):
    if which == "tiny":
        j, t = _pair(list(zip(tiny_tokenizer.vocab[259:], tiny_tokenizer.scores[259:])))
    else:
        j, t = _unicode_pair()
    j.save(tmp_path / "j.bin")
    t.save(tmp_path / "t.bin")
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    # each package loads the other's file, and saves it back byte for byte
    tl = ttok.Tokenizer.load(tmp_path / "j.bin", vocab_size=t.vocab_size)
    jl = jtok.Tokenizer.load(tmp_path / "t.bin", vocab_size=t.vocab_size)
    assert tl.vocab == jl.vocab and tl.scores == jl.scores and tl.raw_bytes == jl.raw_bytes
    assert tl.raw_bytes[3 + 0x80] == bytes([0x80])  # the raw byte, not U+FFFD's
    tl.save(tmp_path / "again.bin")
    assert (tmp_path / "again.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    for text in TEXTS:
        assert _encode(tl, text) == _encode(jl, text, py=True), text


def test_native_bpe_equals_python(tiny_tokenizer):
    """The native encoder, where ``g++`` builds it, equals the Python one;
    where it cannot be built the tokenizer encodes in Python."""
    if not fast_bpe.available():
        pytest.skip("g++ / the native build is unavailable")
    for j, t in (_pair(list(zip(tiny_tokenizer.vocab[259:], tiny_tokenizer.scores[259:]))),
                 _unicode_pair()):
        native = fast_bpe.NativeBpe(t.vocab, t.scores)
        for text in TEXTS + ["time upon a time " * 50]:
            try:
                got = native.encode(text)
            except ValueError as e:
                got = ("raises", str(e))
            assert got == _encode(t, text, py=True), text
        assert t._get_native() is not None


def test_python_encoder_where_native_is_unavailable(monkeypatch, tiny_tokenizer):
    monkeypatch.setattr(fast_bpe, "_lib", False)
    t = ttok.make_byte_tokenizer(list(zip(tiny_tokenizer.vocab[259:],
                                          tiny_tokenizer.scores[259:])))
    assert t.encode("Once upon a time") == tiny_tokenizer.encode("Once upon a time")
    assert t._native is False

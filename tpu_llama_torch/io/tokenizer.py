"""`tokenizer.bin` parser and greedy BPE encoder.

Port of tpu_llama/io/tokenizer.py (host code: no device work).  Binary
format (llama2.ts:442-449):

    i32 max_token_length
    vocab_size x ( f32 score, i32 len, `len` utf-8 bytes )

Encoding reproduces the reference's greedy merge loop (llama2.ts:305-344)
exactly, tie rules included:

* seed tokens are per-UTF-16-code-unit vocabulary lookups -- JS ``charAt``
  iterates UTF-16 units (llama2.ts:308-312), so an astral character is two
  surrogate halves; an unknown unit raises ValueError;
* ``vocab.indexOf`` returns the FIRST matching index: the vocab holds
  duplicate strings (every raw byte 0x80-0xFF decodes to U+FFFD under
  TextDecoder), so a lookup maps a string to its lowest id;
* each round merges the adjacent pair whose merged token has the strictly
  highest score (``>`` at llama2.ts:324): ties go to the earliest pair.

Hash maps replace the reference's O(V) scans (same results).  The native
encoder (``io.fast_bpe``, ``native/bpe.cpp``) runs where ``g++`` builds it;
the Python one elsewhere.
"""

from __future__ import annotations

import os
import struct
from typing import Sequence

BOS = 1  # sentencepiece <s> (llama2.ts:463)
EOS = 2  # </s> -- the reference never special-cases it; generation stops on BOS


def _utf16_units(text: str) -> list[str]:
    """Split text the way JS ``charAt`` does: one UTF-16 code unit per entry."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp > 0xFFFF:  # an astral code point: its two surrogate halves
            cp -= 0x10000
            out.append(chr(0xD800 + (cp >> 10)))
            out.append(chr(0xDC00 + (cp & 0x3FF)))
        else:
            out.append(ch)
    return out


class Tokenizer:
    def __init__(self, vocab: Sequence[str], scores: Sequence[float],
                 raw_bytes: Sequence[bytes] | None = None):
        if len(vocab) != len(scores):
            raise ValueError("vocab/scores length mismatch")
        self.vocab = list(vocab)
        self.scores = [float(s) for s in scores]
        # each token's bytes as stored: decoding maps invalid utf-8 (raw
        # bytes 0x80-0xFF) to U+FFFD, so save() writes these to round-trip
        self.raw_bytes = list(raw_bytes) if raw_bytes is not None else [
            t.encode("utf-8") for t in self.vocab]
        self._native = None  # the native encoder, built at first use; False: unavailable
        self._index: dict[str, int] = {}  # string -> FIRST index (Array.prototype.indexOf)
        for i, tok in enumerate(self.vocab):
            self._index.setdefault(tok, i)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---- binary IO ----
    @classmethod
    def load(cls, path: str | os.PathLike, vocab_size: int = 32000) -> "Tokenizer":
        with open(path, "rb") as f:
            data = f.read()
        pos = 4  # i32 max_token_length, ignored (llama2.ts:445)
        vocab, scores, raws = [], [], []
        for _ in range(vocab_size):
            score, n = struct.unpack_from("<fi", data, pos)
            raw = data[pos + 8:pos + 8 + n]
            pos += 8 + n
            scores.append(score)
            raws.append(raw)
            vocab.append(raw.decode("utf-8", errors="replace"))  # TextDecoder semantics
        return cls(vocab, scores, raw_bytes=raws)

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "wb") as f:
            f.write(struct.pack("<i", max((len(e) for e in self.raw_bytes), default=0)))
            for score, raw in zip(self.scores, self.raw_bytes):
                f.write(struct.pack("<fi", score, len(raw)))
                f.write(raw)

    # ---- encode (llama2.ts:305-344) ----
    def encode(self, text: str, bos: bool = False, eos: bool = False) -> list[int]:
        native = self._get_native()
        tokens = native.encode(text) if native is not None else self._encode_py(text)
        if bos:
            tokens.insert(0, BOS)
        if eos:
            tokens.append(EOS)
        return tokens

    def _get_native(self):
        """The native encoder (``io.fast_bpe.NativeBpe``), built at first
        use; None where it cannot be built (no ``g++``), and the Python
        encoder runs instead.  Both give the same tokens (tests hold them
        equal)."""
        if self._native is None:
            from tpu_llama_torch.io.fast_bpe import NativeBpe

            try:
                self._native = NativeBpe(self.vocab, self.scores)
            except ImportError:
                self._native = False
        return self._native or None

    def _encode_py(self, text: str) -> list[int]:
        tokens: list[int] = []
        for ch in _utf16_units(text):
            tid = self._index.get(ch)
            if tid is None:  # llama2.ts:310 throws
                raise ValueError(f"character not found in vocab: {ch!r}")
            tokens.append(tid)
        while True:
            best_score, best_id, best_idx = -1e10, -1, -1
            for i in range(len(tokens) - 1):
                tid = self._index.get(self.vocab[tokens[i]] + self.vocab[tokens[i + 1]])
                if tid is not None and self.scores[tid] > best_score:
                    best_score, best_id, best_idx = self.scores[tid], tid, i
            if best_idx == -1:
                return tokens
            tokens[best_idx:best_idx + 2] = [best_id]

    # ---- decode ----
    def decode_token(self, token: int, prev_token: int = 0) -> str:
        """One token's text, with the reference's rule: right after a BOS
        one leading space is stripped (llama2.ts:502)."""
        s = self.vocab[token]
        if prev_token == BOS and s.startswith(" "):
            s = s[1:]
        return s

    def decode(self, tokens: Sequence[int], prev_token: int = BOS) -> str:
        out = []
        prev = prev_token
        for t in tokens:
            out.append(self.decode_token(t, prev))
            prev = t
        return "".join(out)


def make_byte_tokenizer(extra: Sequence[tuple[str, float]] = ()) -> Tokenizer:
    """A synthetic tokenizer in llama2.c's layout: tokens 0-2 the <unk>,
    BOS and EOS markers, 3..258 the raw bytes 0x00-0xFF (decoded with
    utf-8/replace, as the real tokenizer.bin stores them), then ``extra``'s
    (token, score) pairs."""
    vocab = ["<unk>", "\n<s>\n", "\n</s>\n"]
    scores = [0.0, 0.0, 0.0]
    raws = [t.encode("utf-8") for t in vocab]
    for b in range(256):
        vocab.append(bytes([b]).decode("utf-8", errors="replace"))
        raws.append(bytes([b]))  # save() writes the byte, not U+FFFD
        scores.append(-1e6)  # byte fallbacks: never merged into
    for tok, score in extra:
        vocab.append(tok)
        raws.append(tok.encode("utf-8"))
        scores.append(score)
    return Tokenizer(vocab, scores, raw_bytes=raws)

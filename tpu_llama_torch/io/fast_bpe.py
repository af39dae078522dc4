"""ctypes binding of the native C++ BPE encoder (``native/bpe.cpp``).

Port of tpu_llama/io/fast_bpe.py: the same merge semantics as
``Tokenizer._encode_py`` (UTF-16 units, first-index lookups, ties to the
first pair).  The library is built with ``g++`` at first use into
``build/native/`` (``tpu_llama_torch.native``); nothing is built at import
time.  ``NativeBpe`` raises ImportError at construction where it cannot be
built, and ``Tokenizer`` then encodes in Python.  Host code only.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu_llama_torch import native

_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_TOO_SMALL = -1000000000  # bpe_encode: the output buffer is too small
_lib = None  # None: not tried yet; False: no compiler or no source


def _load():
    global _lib
    if _lib is None:
        path = native.build("bpe.cpp", "bpe", ("g++",), ("-O3", "-shared", "-fPIC", "-std=c++17"),
                            suffix=".so")
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(str(path))
        lib.bpe_create.restype = ctypes.c_void_p
        lib.bpe_create.argtypes = [_U16P, _I32P, ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
        lib.bpe_encode.restype = ctypes.c_int32
        lib.bpe_encode.argtypes = [ctypes.c_void_p, _U16P, ctypes.c_int32, _I32P, ctypes.c_int32]
        lib.bpe_free.restype = None
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib or None


def _utf16_units(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-16-le", errors="surrogatepass"), dtype=np.uint16)


class NativeBpe:
    """The native encoder over one vocabulary."""

    def __init__(self, vocab, scores):
        lib = _load()
        if lib is None:
            raise ImportError("native BPE unavailable (no g++ or no native/bpe.cpp)")
        self._lib = lib
        units = [_utf16_units(t) for t in vocab]
        offsets = np.zeros(len(vocab) + 1, np.int32)
        np.cumsum([len(u) for u in units], out=offsets[1:])
        data = np.ascontiguousarray(np.concatenate(units) if units else np.zeros(0), np.uint16)
        scores32 = np.ascontiguousarray(scores, np.float32)
        # bpe_create copies what it keeps; the arrays stay referenced until it returns
        self._h = lib.bpe_create(data.ctypes.data_as(_U16P), offsets.ctypes.data_as(_I32P),
                                 len(vocab), scores32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def encode(self, text: str) -> list[int]:
        units = _utf16_units(text)
        out = np.zeros(max(len(units), 1), np.int32)
        n = self._lib.bpe_encode(self._h, units.ctypes.data_as(_U16P), len(units),
                                 out.ctypes.data_as(_I32P), len(out))
        if n == _TOO_SMALL:
            raise RuntimeError("output buffer too small")
        if n < 0:  # -(index of the first unknown unit) - 1
            raise ValueError(f"character not found in vocab: {chr(units[-n - 1])!r}")
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bpe_free(self._h)


def available() -> bool:
    return _load() is not None

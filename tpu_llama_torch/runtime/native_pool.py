"""ctypes binding of the native C++ page allocator (``native/pagepool.cpp``).

Port of tpu_llama/runtime/native_pool.py: the same semantics as
``runtime.paged.PagePool`` (full reservation, trash page 0, refcounted
prefix sharing); the page-table mirror is a numpy array whose memory the
C++ pool writes in place, so an admission makes no Python list churn.  The
library is built with ``g++`` at first use into ``build/native/`` at the
repo root (its file name carries a hash of the source, so an edited source
rebuilds); nothing is built at import time.  ``NativePagePool`` raises
ImportError at construction when no compiler is available, and the engine
then takes the Python pool.  Host bookkeeping only: no device code.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu_llama_torch import native

_I32P = ctypes.POINTER(ctypes.c_int32)
_lib = None  # None: not tried yet; False: no compiler or no source


def _load():
    global _lib
    if _lib is None:
        path = native.build("pagepool.cpp", "pagepool", ("g++",),
                            ("-O3", "-shared", "-fPIC", "-std=c++17"), suffix=".so")
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(str(path))
        lib.pool_create.restype = ctypes.c_void_p
        lib.pool_create.argtypes = [ctypes.c_int32] * 4 + [_I32P]
        lib.pool_destroy.argtypes = [ctypes.c_void_p]
        for name, args in (
                ("pool_pages_needed", [ctypes.c_void_p, ctypes.c_int32]),
                ("pool_free_pages", [ctypes.c_void_p]),
                ("pool_can_reserve", [ctypes.c_void_p, ctypes.c_int32]),
                ("pool_refcount", [ctypes.c_void_p, ctypes.c_int32]),
                ("pool_held", [ctypes.c_void_p, ctypes.c_int32]),
                ("pool_alloc_page", [ctypes.c_void_p]),
                ("pool_retain", [ctypes.c_void_p, _I32P, ctypes.c_int32]),
                ("pool_release_pages", [ctypes.c_void_p, _I32P, ctypes.c_int32]),
                ("pool_reserve", [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]),
                ("pool_reserve_with_prefix",
                 [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, _I32P, ctypes.c_int32,
                  ctypes.c_int32, _I32P, _I32P]),
                ("pool_release", [ctypes.c_void_p, ctypes.c_int32])):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int32
            fn.argtypes = args
        _lib = lib
    return _lib or None


def _as_i32(pages) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(list(pages), np.int32))


class NativePagePool:
    """Drop-in twin of ``runtime.paged.PagePool`` backed by C++."""

    def __init__(self, num_pages: int, page_size: int, slots: int, max_pages_per_slot: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the trash page)")
        lib = _load()
        if lib is None:
            raise ImportError("native page pool unavailable (no g++ or no native/pagepool.cpp)")
        self._lib = lib
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_pages_per_slot = max_pages_per_slot
        self.table = np.zeros((slots, max_pages_per_slot), np.int32)
        self._h = lib.pool_create(num_pages, page_size, slots, max_pages_per_slot,
                                  self.table.ctypes.data_as(_I32P))
        if not self._h:
            raise RuntimeError("pool_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pool_destroy(h)
            self._h = None

    # ---- queries ----
    def pages_needed(self, n_tokens: int) -> int:
        return int(self._lib.pool_pages_needed(self._h, n_tokens))

    def can_reserve(self, n_tokens: int) -> bool:
        return bool(self._lib.pool_can_reserve(self._h, n_tokens))

    @property
    def free_pages(self) -> int:
        return int(self._lib.pool_free_pages(self._h))

    def refcount(self, page: int) -> int:
        return int(self._lib.pool_refcount(self._h, page))

    # ---- raw page holds ----
    def alloc_page(self) -> int | None:
        p = int(self._lib.pool_alloc_page(self._h))
        return None if p < 0 else p

    def retain(self, pages) -> None:
        arr = _as_i32(pages)
        rc = self._lib.pool_retain(self._h, arr.ctypes.data_as(_I32P), len(arr))
        assert rc == 0, "retain of dead page"

    def release_pages(self, pages) -> None:
        arr = _as_i32(pages)
        rc = self._lib.pool_release_pages(self._h, arr.ctypes.data_as(_I32P), len(arr))
        assert rc == 0, "double free"

    # ---- slot lifecycle ----
    def reserve(self, slot: int, n_tokens: int):
        rc = int(self._lib.pool_reserve(self._h, slot, n_tokens))
        if rc == -2:
            raise ValueError(f"slot {slot} already holds pages")
        if rc < 0:
            return None
        return self.table[slot].copy()

    def reserve_with_prefix(self, slot: int, n_tokens: int, prefix_pages, prefix_len: int):
        arr = _as_i32(prefix_pages)
        src = ctypes.c_int32(-1)
        dst = ctypes.c_int32(-1)
        rc = int(self._lib.pool_reserve_with_prefix(
            self._h, slot, n_tokens, arr.ctypes.data_as(_I32P), len(arr), prefix_len,
            ctypes.byref(src), ctypes.byref(dst)))
        if rc == -2:
            raise ValueError(f"slot {slot} already holds pages")
        if rc == -3:
            raise AssertionError("bad prefix pin list")
        if rc < 0:
            return None
        copies = [(int(src.value), int(dst.value))] if src.value >= 0 else []
        return self.table[slot].copy(), copies

    def release(self, slot: int) -> bool:
        return int(self._lib.pool_release(self._h, slot)) > 0

    def held(self, slot: int) -> int:
        return int(self._lib.pool_held(self._h, slot))

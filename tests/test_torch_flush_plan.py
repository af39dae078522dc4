"""The flush wrappers' cached launches (K10 ``kv_cache_flush_rows``, K14
``kv_pool_flush_rows``), on the CPU.

A wrapper checks a flush's tensors once per key (every tensor's data
pointer, shape, dtype and contiguity) and keeps the packed C arguments of
the launch.  Here the card path runs on CPU tensors with the C entry point
replaced by a recorder: a repeated call launches with the kept arguments
and checks nothing again; a changed shape, dtype, contiguity or pointer
is a new key, checked anew, and still raises on what the kernel does not
take.  The plain versions' agreement with the JAX package is held by
tests/test_torch_decode_attention.py, test_torch_fp_attention.py and
test_torch_paged.py.
"""

import numpy as np
import pytest
import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

L, B, KVH, S, HD = 3, 4, 2, 16, 32
P, PS, MP = 9, 8, 2


@pytest.fixture
def card(monkeypatch):
    """The wrappers' card path on CPU tensors: the C entry point records
    (kernel, its packed arguments) and returns 0; the plans start empty."""
    launched = []

    def entry(kernel):
        def fn(args, stream):
            launched.append((kernel, list(args)))
            return 0
        return fn

    monkeypatch.setattr(_kernels, "on_cpu", lambda kernel, *tensors: False)
    monkeypatch.setattr(_kernels, "entry", entry)
    monkeypatch.setattr(_kernels, "device_stream", lambda index: 0)
    monkeypatch.setattr(tatt, "_FLUSH_PLANS", {})
    return launched


@pytest.fixture
def checks(monkeypatch):
    """How many times each wrapper ran its full checks."""
    n = {"K10": 0, "K14": 0}
    for name, k in (("_check_flush", "K10"), ("_check_pool_flush", "K14")):
        def spy(*a, _f=getattr(tatt, name), _k=k):
            n[_k] += 1
            return _f(*a)
        monkeypatch.setattr(tatt, name, spy)
    return n


def _rng(seed):
    return np.random.default_rng(seed)


def _i8(rng, *shape):
    return torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8)


def _f32(rng, *shape):
    return torch.tensor(rng.random(shape), dtype=torch.float32)


def _dense(seed=0, dtype=torch.int8, hd=HD):
    rng = _rng(seed)
    if dtype == torch.int8:
        rows = [_i8(rng, L, B, KVH, hd), _i8(rng, L, B, KVH, hd), _f32(rng, L, B, KVH),
                _f32(rng, L, B, KVH)]
        cache = [_i8(rng, L, B, KVH, S, hd), _i8(rng, L, B, KVH, S, hd), _f32(rng, L, B, KVH, S),
                 _f32(rng, L, B, KVH, S)]
    else:
        rows = [_f32(rng, L, B, KVH, hd).to(dtype) for _ in range(2)] + [None, None]
        cache = [_f32(rng, L, B, KVH, S, hd).to(dtype) for _ in range(2)] + [None, None]
    pos = torch.tensor([0, 3, S - 1, S], dtype=torch.int32)
    return rows, pos, cache


def _k10(rows, pos, cache):
    return tatt.kv_cache_flush_rows(rows[0], rows[1], pos, cache[0], cache[1], rows[2], rows[3],
                                    cache[2], cache[3])


def _paged(seed=0):
    rng = _rng(seed)
    rows = [_i8(rng, L, B, KVH, HD), _i8(rng, L, B, KVH, HD), _f32(rng, L, B, KVH),
            _f32(rng, L, B, KVH)]
    pool = [_i8(rng, L, P, KVH, PS, HD), _i8(rng, L, P, KVH, PS, HD), _f32(rng, L, P, KVH, PS),
            _f32(rng, L, P, KVH, PS)]
    table = torch.tensor(rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP),
                         dtype=torch.int32)
    pos = torch.tensor([0, 9, 2 * PS, 5], dtype=torch.int32)
    return rows, pos, table, pool


def _k14(rows, pos, table, pool):
    return tatt.kv_pool_flush_rows(*rows, pos, table, *pool)


def _ptr(t):
    return 0 if t is None else t.data_ptr()


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32, torch.bfloat16])
def test_k10_launch_kept_per_key(card, checks, dtype):
    rows, pos, cache = _dense(1, dtype)
    before = _kernels.LAUNCHES[_kernels.form("K10", dtype)]
    out = _k10(rows, pos, cache)
    assert all(a is b for a, b in zip(out, cache))
    out = _k10(rows, pos, cache)
    assert checks["K10"] == 1 and len(card) == 2 and card[0] == card[1]
    assert _kernels.LAUNCHES[_kernels.form("K10", dtype)] == before + 2
    kernel, args = card[0]
    assert kernel == _kernels.form("K10", dtype)
    assert args[:9] == [_ptr(t) for t in (*rows, pos, *cache)]
    assert args[9:] == [_kernels.cache_code(dtype), L, B, KVH, S, HD, 1]
    assert len(out) == (4 if dtype == torch.int8 else 2)


def test_k10_rows_not_16_bytes_copy_elementwise(card):
    rows, pos, cache = _dense(2, hd=12)
    _k10(rows, pos, cache)
    assert card[0][1][-2:] == [12, 0]


@pytest.mark.parametrize("change", ["shape", "dtype", "cache_dtype", "noncontiguous_cache",
                                    "fp_scales", "pos_shape"])
def test_k10_changed_key_checked_anew(card, checks, change):
    rows, pos, cache = _dense(3)
    _k10(rows, pos, cache)
    err = ValueError
    if change == "shape":
        rows = [r[:, :B - 1] for r in rows]
    elif change == "dtype":
        rows[0], err = rows[0].float(), TypeError
    elif change == "cache_dtype":
        cache[0], err = cache[0].to(torch.uint8), TypeError
    elif change == "noncontiguous_cache":
        cache[1] = cache[1].transpose(3, 4).contiguous().transpose(3, 4)
    elif change == "fp_scales":
        cache = [c.float() for c in cache[:2]] + cache[2:]
        rows = [r.float() for r in rows[:2]] + rows[2:]
    else:
        pos = pos[:B - 1]
    with pytest.raises(err):
        _k10(rows, pos, cache)
    assert checks["K10"] == 2 and len(card) == 1


def test_k10_changed_pointer_launches_its_own(card, checks):
    rows, pos, cache = _dense(4)
    _k10(rows, pos, cache)
    other = [c.clone() for c in cache]
    _k10(rows, pos, other)
    assert checks["K10"] == 2
    assert card[1][1][5:9] == [t.data_ptr() for t in other]
    _k10(rows, pos, cache)
    assert checks["K10"] == 2 and card[2] == card[0]


def test_k10_converts_what_the_kernel_reads(card):
    rows, pos, cache = _dense(5)
    rk = rows[0].transpose(0, 1).contiguous().transpose(0, 1)  # same values, not contiguous
    p64 = pos.long()
    _k10([rk, *rows[1:]], p64, cache)
    args = card[0][1]
    assert args[0] not in (0, rk.data_ptr()) and args[4] not in (0, p64.data_ptr())
    assert args[5:9] == [t.data_ptr() for t in cache]


def test_k14_launch_kept_per_key(card, checks):
    rows, pos, table, pool = _paged(6)
    before = _kernels.LAUNCHES["K14"]
    out = _k14(rows, pos, table, pool)
    assert all(a is b for a, b in zip(out, pool))
    _k14(rows, pos, table, pool)
    assert checks["K14"] == 1 and len(card) == 2 and card[0] == card[1]
    assert _kernels.LAUNCHES["K14"] == before + 2
    kernel, args = card[0]
    assert kernel == "K14"
    assert args[:10] == [t.data_ptr() for t in (*rows, pos, table, *pool)]
    assert args[10:] == [L, B, KVH, P, PS, MP, HD, 1]


@pytest.mark.parametrize("change", ["shape", "dtype", "table_dtype", "noncontiguous_pool",
                                    "pool_shape"])
def test_k14_changed_key_checked_anew(card, checks, change):
    rows, pos, table, pool = _paged(7)
    _k14(rows, pos, table, pool)
    err = ValueError
    if change == "shape":
        rows[2] = rows[2][:, :, :KVH - 1]
    elif change == "dtype":
        rows[1], err = rows[1].to(torch.uint8), TypeError
    elif change == "table_dtype":
        table, err = table.long(), TypeError
    elif change == "noncontiguous_pool":
        pool[3] = pool[3].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        pool[0] = pool[0][:, :, :, :PS - 1]
    with pytest.raises(err):
        _k14(rows, pos, table, pool)
    assert checks["K14"] == 2 and len(card) == 1


def test_k14_converts_what_the_kernel_reads(card, checks):
    rows, pos, table, pool = _paged(8)
    t2 = table.t().contiguous().t()  # same values, not contiguous
    p64 = pos.long()
    _k14(rows, p64, t2, pool)
    args = card[0][1]
    assert args[4] != p64.data_ptr() and args[5] != t2.data_ptr()
    assert args[6:10] == [t.data_ptr() for t in pool]


def test_plain_path_not_kept(checks):
    """On CPU tensors the wrappers run the plain versions, checked at every
    call (nothing is kept for them)."""
    rows, pos, cache = _dense(9)
    want = [c.clone() for c in cache]
    tatt.kv_cache_flush_rows_plain(rows[0], rows[1], pos, want[0], want[1], rows[2], rows[3],
                                   want[2], want[3])
    for _ in range(2):
        _k10(rows, pos, cache)
    assert checks["K10"] == 2
    assert all(torch.equal(a, b) for a, b in zip(cache, want))
    rows, pos, table, pool = _paged(10)
    want = [a.clone() for a in pool]
    tatt.kv_pool_flush_rows_plain(*rows, pos, table, *want)
    for _ in range(2):
        _k14(rows, pos, table, pool)
    assert checks["K14"] == 2
    assert all(torch.equal(a, b) for a, b in zip(pool, want))


@pytest.mark.parametrize("kv,paged", [("int8", False), ("int8", True), ("bfloat16", False),
                                      ("float32", False)])
def test_step_buffers_hold_the_stacked_rows(kv, paged):
    """A deferred-flush step writes each layer's rows into the step's flush
    buffers (``_flush_buffers``, the quant or cast ``out=``): the rows and
    the flushed cache equal those of per-layer rows stacked at the flush
    (which an f32 cache keeps)."""
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl

    cfg = ModelConfig(dim=64, hidden_dim=128, n_layers=3, n_heads=4, n_kv_heads=2, vocab_size=32,
                      seq_len=32)
    rng = _rng(11)
    caches = [tl.make_kv_cache(cfg, 4, kv, paged=paged, page_size=8, num_pages=17, device="cpu")
              for _ in range(2)]
    if paged:
        table = torch.tensor(rng.permutation(np.arange(1, 17)).reshape(4, 4), dtype=torch.int32)
        for c in caches:
            c.page_table.copy_(table)
    pos = torch.tensor([0, 5, 17, 31], dtype=torch.int32)
    bufs, views = tl._flush_buffers(caches[0], 4)
    assert (bufs is None) == (kv == "float32") and len(views) == cfg.n_layers
    rows = [[], []]
    for i in range(cfg.n_layers):
        k, v = (torch.tensor(rng.standard_normal((4, 2, 16)), dtype=torch.float32)
                for _ in range(2))
        rows[0].append(tl._cache_rows(caches[0], k, v, views[i]))
        rows[1].append(tl._cache_rows(caches[1], k, v))
        assert rows[0][-1].keys() == rows[1][-1].keys()
        assert all(torch.equal(rows[0][-1][n], rows[1][-1][n]) for n in rows[1][-1])
    tl._flush(caches[0], rows[0], pos, bufs)
    tl._flush(caches[1], rows[1], pos)
    names = ("k", "v", "ks", "vs") if kv == "int8" else ("k", "v")
    assert all(torch.equal(getattr(caches[0], n), getattr(caches[1], n)) for n in names)
    assert bool((caches[0].k != 0).any())  # the flush wrote something

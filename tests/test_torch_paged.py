"""Port parity for the paged INT8 KV serving path.

* ``PagePool`` and ``NativePagePool`` (the port's) against the JAX
  package's ``PagePool``, op for op over random reserve, release, prefix,
  pin and unpin sequences: tables, free counts and refcounts equal.
* The plain versions of K15 ``kv_pool_scatter_pages`` and K14
  ``kv_pool_flush_rows`` against the JAX kernels (Pallas in interpret mode
  on the CPU): copies, so the pools are bit-equal -- outside the trash page
  0, which several slots may write at once in no set order.
* The plain versions of K13 ``paged_flash_decode_attention_dma`` and K20
  ``paged_flash_decode_attention_fresh`` against the JAX kernels: within
  2^-8 of max |jax|, the limit of tests/test_torch_decode_attention.py and
  for its reason (the same rounding points, f32 sums in another order, which
  can flip one bf16(p * vs) by one step).
* The model and the engine: a paged ``greedy_decode_loop`` equals the dense
  INT8 one token for token; the paged ``Engine`` + ``ContinuousBatcher``
  streams (host and device sampling, prefix reuse) equal the JAX paged
  engine's; slot reuse returns every page, a one-slot pool admits under
  backpressure, concurrent equals solo, prefix pins are released on
  eviction, a pool that cannot spare a boundary page caches nothing, and an
  admission group above the pool-direct gate is prefilled straight into
  the pool (tests/test_torch_paged_prefill.py holds that path to JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import TINY128, TINY_GQA, build_fused_pair, build_pair
from tpu_llama.models import llama as jl
from tpu_llama.ops import attention as jatt
from tpu_llama.runtime import ContinuousBatcher as JaxBatcher
from tpu_llama.runtime import Engine as JaxEngine
from tpu_llama.runtime import Request as JaxRequest
from tpu_llama.runtime.paged import PagePool as JaxPagePool
from tpu_llama_torch import convert
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.runtime import ContinuousBatcher, Engine, PagePool, Request
from tpu_llama_torch.runtime import engine as engine_mod
from tpu_llama_torch.runtime.native_pool import NativePagePool

torch.set_num_threads(1)

TOL = 2.0 ** -8
CFG = dict(TINY_GQA, seq_len=128)


# ---------------------------------------------------------------------------
# the host page pools
# ---------------------------------------------------------------------------


POOLS = {"python": PagePool, "native": NativePagePool}


def _same(ref, pool):
    assert ref.free_pages == pool.free_pages
    np.testing.assert_array_equal(ref.table, pool.table)
    for pg in range(ref.num_pages):
        assert ref.refcount(pg) == pool.refcount(pg), pg


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_pool_matches_jax_random_ops(kind):
    """The JAX pool and the port's, op for op (tests/test_native_pool.py's
    sequence)."""
    ref, pool = JaxPagePool(17, 16, 6, 4), POOLS[kind](17, 16, 6, 4)
    rng = np.random.default_rng(7)
    snaps = []
    for _ in range(300):
        op, slot = int(rng.integers(0, 5)), int(rng.integers(0, 6))
        if op == 0 and not ref.held(slot):  # reserve
            n = int(rng.integers(1, 4 * 16 + 1))
            a, b = ref.reserve(slot, n), pool.reserve(slot, n)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        elif op == 1:  # release
            assert ref.release(slot) == pool.release(slot)
        elif op == 2 and ref.held(slot):  # a snapshot pins the slot's first pages
            pages = [int(p) for p in ref.table[slot] if p > 0]
            length = int(rng.integers(1, len(pages) * 16 + 1))
            pin = pages[:ref.pages_needed(length)]
            ref.retain(pin)
            pool.retain(pin)
            snaps.append((pin, length))
        elif op == 3 and snaps and not ref.held(slot):  # a prefix restore
            pin, length = snaps[int(rng.integers(0, len(snaps)))]
            n = int(rng.integers(length, 4 * 16 + 1))
            a = ref.reserve_with_prefix(slot, n, pin, length)
            b = pool.reserve_with_prefix(slot, n, pin, length)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1] == b[1]
        elif op == 4 and snaps:  # unpin
            pin, _ = snaps.pop(int(rng.integers(0, len(snaps))))
            ref.release_pages(pin)
            pool.release_pages(pin)
        _same(ref, pool)


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_pool_basics_match_jax(kind):
    ref, pool = JaxPagePool(5, 4, 2, 3), POOLS[kind](5, 4, 2, 3)
    for p in (ref, pool):
        assert p.pages_needed(1) == 1 and p.pages_needed(9) == 3 and p.can_reserve(12)
        assert list(p.reserve(0, 9)) == [1, 2, 3] and p.free_pages == 1
        assert not p.can_reserve(8) and p.reserve(1, 8) is None
        assert p.alloc_page() == 4 and p.alloc_page() is None
        assert p.release(0) and not p.release(0) and p.free_pages == 3
    _same(ref, pool)
    with pytest.raises(ValueError):
        POOLS[kind](1, 4, 2, 3)  # page 0 is the trash page


def test_engine_takes_the_native_pool_unless_asked(monkeypatch):
    assert isinstance(engine_mod._make_page_pool(8, 16, 2, 4), NativePagePool)
    monkeypatch.setenv("TPU_LLAMA_TORCH_NO_NATIVE", "1")
    assert type(engine_mod._make_page_pool(8, 16, 2, 4)) is PagePool


# ---------------------------------------------------------------------------
# K15 and K14 against the JAX kernels
# ---------------------------------------------------------------------------


def _pools(rng, L=2, P=12, KVH=2, ps=16, hd=16):
    return [rng.integers(-127, 128, (L, P, KVH, ps, hd), dtype=np.int8) for _ in range(2)] + \
        [rng.uniform(0, 1, (L, P, KVH, ps)).astype(np.float32) for _ in range(2)]


def _equal_outside_page0(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g)[:, 1:], np.asarray(w)[:, 1:])


@pytest.mark.parametrize("T", [40, 32])
def test_k15_plain_matches_jax(T):
    """T = 40 is no page multiple (the last page's tail is zero-padded);
    slot 2 reserves fewer pages than T covers (its third page lands on the
    trash page), and the page table is out of order."""
    rng = np.random.default_rng(T)
    L, KVH, ps, hd, n = 2, 2, 16, 16, 3
    pool = _pools(rng)
    small = [rng.integers(-127, 128, (L, n, KVH, T, hd), dtype=np.int8) for _ in range(2)] + \
        [rng.uniform(0, 1, (L, n, KVH, T)).astype(np.float32) for _ in range(2)]
    pt = np.array([[9, 4, 0], [0, 0, 0], [3, 0, 0], [5, 11, 7]], np.int32)  # slot 2: one page
    slots = np.array([3, 0, 2], np.int32)
    want = jatt.kv_pool_scatter_pages(*(jnp.asarray(a) for a in small), jnp.asarray(slots),
                                      jnp.asarray(pt), *(jnp.asarray(a) for a in pool))
    got = [torch.tensor(a) for a in pool]
    out = tatt.kv_pool_scatter_pages(*(torch.tensor(a) for a in small), slots.tolist(),
                                     torch.tensor(pt), *got)
    assert all(o is g for o, g in zip(out, got))  # in place
    _equal_outside_page0(got, want)
    if T % ps:  # slot 3's last page past T: int8 0, scale 0
        last = pt[3, T // ps]
        assert not got[0][:, last, :, T % ps:].any() and not got[2][:, last, :, T % ps:].any()


def test_k15_rejects_bad_slots():
    rng = np.random.default_rng(1)
    pool = [torch.tensor(a) for a in _pools(rng)]
    small = [torch.zeros(2, 2, 2, 16, 16, dtype=torch.int8)] * 2 + [torch.zeros(2, 2, 2, 16)] * 2
    pt = torch.zeros(4, 3, dtype=torch.int32)
    for slots in ([0, 0], [0, 4], [1]):
        with pytest.raises(ValueError):
            tatt.kv_pool_scatter_pages(*small, slots, pt, *pool)


def _flush_case(rng, pos, L=2, B=4, KVH=2, hd=16):
    rows = [rng.integers(-127, 128, (L, B, KVH, hd), dtype=np.int8) for _ in range(2)] + \
        [rng.uniform(0, 1, (L, B, KVH)).astype(np.float32) for _ in range(2)]
    pt = np.array([[9, 4, 6], [0, 0, 0], [3, 0, 0], [5, 11, 7]], np.int32)  # slot 1 parked
    return rows, np.asarray(pos, np.int32), pt


@pytest.mark.parametrize("pos", [[17, 0, 15, 47], [0, 3, 16, 48], [40, 9, 100, 31]])
def test_k14_plain_matches_jax(pos):
    """A parked slot (table row 0), a page boundary, the last row of the
    table (47), pos past the table (48, 100: the trash page) and past a
    slot's reservation (slot 2 at 16 and 100)."""
    rng = np.random.default_rng(sum(pos))
    rows, p, pt = _flush_case(rng, pos)
    pool = _pools(rng)
    want = jatt.kv_pool_flush_rows(*(jnp.asarray(a) for a in rows), jnp.asarray(p),
                                   jnp.asarray(pt), *(jnp.asarray(a) for a in pool))
    got = [torch.tensor(a) for a in pool]
    tatt.kv_pool_flush_rows(*(torch.tensor(a) for a in rows), torch.tensor(p), torch.tensor(pt),
                            *got)
    _equal_outside_page0(got, want)


def test_k14_skips_negative_pos_and_bad_pages():
    """The JAX package leaves a negative pos undefined; the port skips it,
    and a page id outside [0, P), so neither can write outside the pool."""
    rng = np.random.default_rng(3)
    rows, p, pt = _flush_case(rng, [-1, 5, 2, 3])
    pt[2, 0], pt[3, 0] = 12, -3  # P is 12
    pool = [torch.tensor(a) for a in _pools(rng)]
    before = [a.clone() for a in pool]
    tatt.kv_pool_flush_rows(*(torch.tensor(a) for a in rows), torch.tensor(p), torch.tensor(pt),
                            *pool)
    changed = [(a != b).flatten(2).any(-1).nonzero()[:, 1].unique().tolist()
               for a, b in zip(pool, before)]
    assert all(c == [0] for c in changed)  # only slot 1's trash-page row


# ---------------------------------------------------------------------------
# K13 and K20 against the JAX kernels
# ---------------------------------------------------------------------------


def _decode_case(seed, G, hd=16, L=2, B=4, KVH=2, P=12, ps=16, pos=(0, 16, 37, 63)):
    """(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k, new_v,
    new_ks, new_vs) as numpy arrays, in the wrappers' argument order; pages
    out of order and shared, pos 0, on a page boundary, inside a page, the
    last row of the table."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    k, v = (rng.integers(-127, 128, (L, P, KVH, ps, hd), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, (L, P, KVH, ps)).astype(np.float32) for _ in range(2))
    pt = np.array([[7, 0, 0, 0], [2, 9, 0, 0], [11, 4, 3, 0], [1, 5, 10, 6]], np.int32)
    nk, nv = (rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8) for _ in range(2))
    nks, nvs = (rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32) for _ in range(2))
    return q, k, v, ks, vs, pt, np.asarray(pos, np.int32), nk, nv, nks, nvs


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("name", ["dma", "fresh"])
def test_paged_decode_plain_matches_jax(name, G):
    arrs = _decode_case(13 + G, G)
    jfn = getattr(jatt, f"paged_flash_decode_attention_{name}")
    tfn = getattr(tatt, f"paged_flash_decode_attention_{name}")
    for layer in range(2):
        want = jfn(*(jnp.asarray(a) for a in arrs), layer=jnp.int32(layer))
        got = tfn(*(torch.tensor(a) for a in arrs), layer=layer)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["dma", "fresh"])
def test_paged_rows_at_and_beyond_pos_are_ignored(name):
    """Rows at and past pos, other pages and page 0 may hold anything
    (poisoned with int8 127 and scale 1e9): the output does not change by
    one bit."""
    fn = getattr(tatt, f"paged_flash_decode_attention_{name}")
    q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs = _decode_case(4, 2)
    args = lambda: [torch.tensor(a) for a in (q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs)]
    base = fn(*args(), layer=1)
    live = np.zeros(k.shape[1:4], bool)  # (page, head, row) below some slot's pos
    for b, p in enumerate(pos):
        for s in range(p):
            live[pt[b, s // 16], :, s % 16] = True
    for arr, val in ((k, 127), (v, 127), (ks, 1e9), (vs, 1e9)):
        arr[1][~live] = val
    assert torch.equal(base, fn(*args(), layer=1))


def test_paged_dma_equals_k9_on_a_paged_copy():
    """K13's plain version on a paged copy of a dense cache equals K9's with
    the same key block (min(256, ps)) bit for bit: the same blocks in the
    same order."""
    rng = np.random.default_rng(9)
    L, B, KVH, G, hd, ps, MP = 2, 3, 2, 2, 16, 16, 4
    S = ps * MP
    dense = [rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2)] + \
        [rng.uniform(0.005, 0.03, (L, B, KVH, S)).astype(np.float32) for _ in range(2)]
    pt = np.array([[5, 2, 9, 1], [3, 7, 4, 11], [8, 6, 10, 12]], np.int32)
    pool = [np.zeros((L, 13, KVH, ps) + a.shape[4:], a.dtype) for a in dense]
    for a, d in zip(pool, dense):
        for b in range(B):
            for j in range(MP):
                a[:, pt[b, j]] = d[:, b, :, j * ps:(j + 1) * ps]
    q = torch.tensor(rng.standard_normal((B, KVH, G, hd)).astype(np.float32))
    nk, nv = (torch.tensor(rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8)) for _ in range(2))
    nks, nvs = (torch.tensor(rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32))
                for _ in range(2))
    pos = torch.tensor([0, 33, 64], dtype=torch.int32)
    t = [torch.tensor(a) for a in pool]
    d = [torch.tensor(a) for a in dense]
    paged = tatt.paged_flash_decode_attention_dma(q, *t, torch.tensor(pt), pos, nk, nv, nks, nvs,
                                                  layer=1)
    k9 = tatt.flash_decode_attention_dma(q, d[0], d[1], pos, nk, nv, d[2], d[3], nks, nvs,
                                         layer=1, block_s=ps)
    assert torch.equal(paged, k9)


def test_k22_equals_k13_with_the_step_row_as_fresh_column():
    """K22 (write-then-attend) on a pool whose row at pos holds the step's
    row equals K13 (deferred flush) with that row as its fresh column,
    within TOL: the same keys, the fresh column merged unrounded by K13 and
    as a bf16(p * vs) block row by K22."""
    q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs = _decode_case(8, 2)
    for b, p in enumerate(pos):
        pg, r = pt[b, p // 16], p % 16
        k[1, pg, :, r], v[1, pg, :, r] = nk[b], nv[b]
        ks[1, pg, :, r], vs[1, pg, :, r] = nks[b], nvs[b]
    t = [torch.tensor(a) for a in (q, k, v, ks, vs, pt, pos, nk, nv, nks, nvs)]
    _close(tatt.paged_flash_decode_attention(*t[:7], layer=1).numpy(),
           tatt.paged_flash_decode_attention_dma(*t, layer=1).numpy())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _paged_cache(cfg, B, ps, device="cpu"):
    """A paged cache whose slots each reserve the whole context from a
    pool that hands out pages out of order (a few released and reserved
    again)."""
    mp = -(-cfg.seq_len // ps)
    pool = PagePool(B * mp + 3, ps, B, mp)
    for s in range(B):
        pool.reserve(s, ps)
    for s in range(B):
        pool.release(s)
        assert pool.reserve(s, cfg.seq_len) is not None
    cache = tl.make_kv_cache(cfg, B, kv_dtype="int8", paged=True, num_pages=B * mp + 3,
                             page_size=ps, device=device)
    cache.page_table = torch.tensor(pool.table)
    return cache


@pytest.mark.parametrize("attn", ["flash", "flash_dma"])
def test_paged_greedy_decode_matches_dense_int8(attn):
    """tests/test_paged.py:52 on the port: the same tokens from a paged
    cache as from a dense INT8 one."""
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=41)
    B, steps = 2, 6
    tokens, pos = torch.tensor([3, 5]), torch.zeros(B, dtype=torch.long)
    dense = tl.make_kv_cache(tcfg, B, kv_dtype="int8", device="cpu")
    want, _ = tl.greedy_decode_loop(tp, dense, tokens, pos, steps, tcfg, attn=attn)
    _kernels.reset_counts()
    got, cache = tl.greedy_decode_loop(tp, _paged_cache(tcfg, B, 8), tokens, pos, steps, tcfg,
                                       attn=attn)
    assert torch.equal(got, want)
    k = "K20" if attn == "flash" else "K13"
    assert _kernels.PLAIN_CALLS[k] == tcfg.n_layers * steps
    assert _kernels.PLAIN_CALLS["K14"] == steps and _kernels.PLAIN_CALLS["K9"] == 0


def test_paged_fused_decode_matches_jax():
    """The two-launch fused decode (K3, K8, then per layer K13, K2, K11; one
    K14) on a paged cache against the JAX package's (interpret mode) on the
    same prefilled pool: logits within 1e-4 of max |logit| (the f32 limit of
    tests/test_torch_model.py), the pools equal after the step but for the
    step's rows, quantized from f32 values that differ by summation order:
    their int8 within one step, their scales within 2^-20."""
    jcfg, jp, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=43)
    B = 2
    tc = _paged_cache(tcfg, B, 16)
    rng = np.random.default_rng(2)
    for a in tc.arrays:  # a prefilled pool: random rows, scales like quantize_kv's
        t = getattr(tc, a)
        t.copy_(torch.tensor(rng.integers(-127, 128, t.shape, dtype=np.int8)) if t.dtype ==
                torch.int8 else torch.tensor(rng.uniform(0.001, 0.01, t.shape).astype(np.float32)))
    jc = jl.PagedKVCache(*(jnp.asarray(getattr(tc, a).numpy()) for a in tc.arrays),
                         page_table=jnp.asarray(tc.page_table.numpy()))
    tokens, pos = np.array([7, 11]), np.array([20, 47])
    want, jc = jl.forward_decode(jp, jc, jnp.asarray(tokens, jnp.int32),
                                 jnp.asarray(pos, jnp.int32), jcfg, attn="flash_dma", fused=True)
    _kernels.reset_counts()
    got, tc = tl.forward_decode(tp, tc, torch.tensor(tokens), torch.tensor(pos), tcfg,
                                attn="flash_dma", fused=True)
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= 1e-4 * np.abs(np.asarray(want)).max(), err
    assert _kernels.PLAIN_CALLS["K11"] == 2 and _kernels.PLAIN_CALLS["K13"] == 2
    assert _kernels.PLAIN_CALLS["K14"] == 1 and _kernels.PLAIN_CALLS["K12"] == 0
    for a in tc.arrays:
        g, w = getattr(tc, a).numpy()[:, 1:], np.asarray(getattr(jc, a))[:, 1:]
        if g.dtype == np.int8:
            assert np.abs(g.astype(np.int32) - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -20, atol=0)


def test_paged_cache_make_resolve_and_numpy():
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=44)
    with pytest.raises(ValueError):
        tl.make_kv_cache(tcfg, 2, kv_dtype="float32", paged=True, device="cpu")
    c = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", paged=True, page_size=32, device="cpu")
    assert isinstance(c, tl.PagedKVCache) and not isinstance(c, tl.QuantKVCache)
    assert c.k.shape == (2, 8, 2, 32, 12) and c.ks.shape == (2, 8, 2, 32)
    assert c.page_table.shape == (2, 4) and c.page_table.dtype == torch.int32
    assert c.seq_len == 128 and c.num_pages == 8 and c.page_size == 32
    # "auto": K20 on the CPU at head_dim 12 (JAX's head_dim % 128 rule); never mega2
    assert tl._resolve_decode_attn("auto", c) == "flash"
    assert tl._resolve_decode_attn("xla", c) == "xla"  # decodes through K13, as in JAX
    assert tl._resolve_fused("auto", "flash", tp, tcfg, c, 2) is False
    with pytest.raises(TypeError, match="forward_prefill_paged_chunked"):
        tl.forward_prefill(tp, c, torch.ones(1, 4, dtype=torch.long), torch.zeros(1),
                           torch.tensor([4]), tcfg)
    # no page reserved: every row goes through table entries 0, the trash page
    last, back = tl.forward_prefill_paged_chunked(tp, c, torch.ones(2, 32, dtype=torch.long),
                                                  torch.tensor([32, 20]), [0, 1], tcfg, chunk=32)
    assert back is c and last.shape == (2, tcfg.vocab_size) and torch.isfinite(last).all()
    assert c.k[:, 0].any() and not c.k[:, 1:].any()
    c.k.random_(-127, 127)
    c.page_table[1] = torch.tensor([3, 4, 5, 6])
    back = convert.cache_from_numpy(convert.cache_to_numpy(c), device="cpu")
    assert isinstance(back, tl.PagedKVCache)
    assert all(torch.equal(getattr(back, a), getattr(c, a))
               for a in ("k", "v", "ks", "vs", "page_table"))


# ---------------------------------------------------------------------------
# the engine and the scheduler
# ---------------------------------------------------------------------------


def _requests(cls, device_sampling=False):
    rng = np.random.default_rng(12)
    lens = [60, 50, 63, 45, 9, 20, 14]
    temps = [0.0, 0.8, 0.0, 1.0, 0.0, 0.7, 0.9]
    out = []
    for i, (n, t) in enumerate(zip(lens, temps)):
        prompt = [int(v) for v in rng.integers(3, CFG["vocab_size"], n)]
        out.append(cls(prompt_tokens=prompt, steps=n + 1 + 10 + i, temperature=t,
                       topp=0.9 if i == 3 else 1.0, seed=100 + i, device_sampling=device_sampling,
                       topk=40 if device_sampling and i % 3 == 2 else 0))
    return out


def _serve(engine, batcher_cls, reqs, **kw):
    b = batcher_cls(engine, **kw)
    for r in reqs:
        b.submit(r)
    b.run()
    return b


@pytest.mark.parametrize("device_sampling", [False, True], ids=["host", "device"])
def test_paged_engine_streams_equal_jax(device_sampling):
    """Four slots, seven requests (slots reused), page size 16: the JAX
    paged engine and the port's (K15, K20 and K14 plain) give equal streams,
    and every page is free again afterwards."""
    jcfg, jp, tcfg, tp = build_pair(CFG, jnp.float32, seed=21)
    kw = dict(max_batch=4, seq_len=128, kv_layout="paged", page_size=16)
    chunk = dict(max_chunk=4) if device_sampling else {}
    jreqs = _requests(JaxRequest, device_sampling)
    _serve(JaxEngine(jp, jcfg, **kw), JaxBatcher, jreqs, **chunk)
    _kernels.reset_counts()
    eng = Engine(tp, tcfg, device="cpu", **kw)
    treqs = _requests(Request, device_sampling)
    _serve(eng, ContinuousBatcher, treqs, **chunk)
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert sum(len(r.out_tokens) for r in treqs) > 40
    plain = _kernels.PLAIN_CALLS
    assert plain["K15"] >= 2 and plain["K7"] == 0 and plain["K10"] == 0 and plain["K9"] == 0
    assert plain["K20"] == tcfg.n_layers * plain["K14"] and plain["K14"] > 0
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert not any(eng.pool.refcount(p) for p in range(eng.pool.num_pages))


def test_paged_fused_engine_streams_equal_jax():
    """Fused W8A8 layouts at head_dim 128: "auto" is K13 on both sides (the
    JAX engine's CPU decode is unfused, so the port's is asked for the
    same)."""
    jcfg, jp, tcfg, tp = build_fused_pair(dict(TINY128, seq_len=128), jnp.float32, seed=22)
    kw = dict(max_batch=4, seq_len=128, kv_layout="paged", page_size=32)
    jreqs = _requests(JaxRequest)[:5]
    _serve(JaxEngine(jp, jcfg, **kw), JaxBatcher, jreqs)
    _kernels.reset_counts()
    eng = Engine(tp, tcfg, device="cpu", **kw)
    assert eng.decode_attn == "flash_dma" and eng.decode_fused is False
    treqs = _requests(Request)[:5]
    _serve(eng, ContinuousBatcher, treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    plain = _kernels.PLAIN_CALLS
    assert plain["K5"] > 0 and plain["K15"] > 0 and plain["K13"] == 2 * plain["K14"] > 0


def _tiny_engine(seed=30, **kw):
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=seed)
    kw = dict(dict(max_batch=4, seq_len=64, kv_layout="paged", page_size=8), **kw)
    return Engine(tp, tcfg, device="cpu", **kw)


def _run_one(batcher, prompt, steps=20):
    req = Request(prompt_tokens=list(prompt), steps=steps, temperature=0.0, seed=1)
    batcher.submit(req)
    batcher.run()
    return req.out_tokens


def test_paged_slot_reuse_backpressure_and_solo():
    """More requests than slots recycle every page; a pool with room for
    one request at a time (one slot's pages) serves them all, admitting
    under backpressure; concurrent streams equal solo runs."""
    prompts = [[40, 41, 42, 43], [50], [60, 61]]
    solo = [_run_one(ContinuousBatcher(_tiny_engine()), p) for p in prompts]
    eng = _tiny_engine()
    reqs = [Request(prompt_tokens=p, steps=20, temperature=0.0, seed=1) for p in prompts * 3]
    _serve(eng, ContinuousBatcher, reqs)
    assert [r.out_tokens for r in reqs] == solo * 3
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    small = _tiny_engine(num_pages=1 + 64 // 8)  # exactly one full slot
    admitted = []
    can = small.can_admit
    small.can_admit = lambda *a: admitted.append(can(*a)) or admitted[-1]
    reqs = [Request(prompt_tokens=prompts[0], steps=64, temperature=0.0, seed=1)
            for _ in range(3)]
    _serve(small, ContinuousBatcher, reqs)
    assert all(r.done for r in reqs) and len({tuple(r.out_tokens) for r in reqs}) == 1
    assert False in admitted  # the pool held requests back
    assert small.pool.free_pages == small.pool.num_pages - 1


@pytest.mark.parametrize("prefix_len", [7, 8], ids=["unaligned", "aligned"])
def test_paged_prefix_reuse(prefix_len):
    """A prefix whose fed length (BOS + prompt) is page-aligned (pure page
    sharing) and one that is not (a boundary page copied): the continued
    stream equals an uncached engine's, a whole-prompt hit runs no prefill
    and gives the first stream again, and eviction plus retirement release
    every pin."""
    base = list(range(40, 40 + prefix_len - 1))
    longer = base + [70, 71, 72]
    b0 = ContinuousBatcher(_tiny_engine())
    _run_one(b0, base)
    want = _run_one(b0, longer)
    eng = _tiny_engine()
    b = ContinuousBatcher(eng, prefix_cache_size=1)
    first = _run_one(b, base)
    pinned = len(next(iter(b._prefix.values()))["snap"]["pages"])
    assert pinned == 1 and eng.pool.free_pages == eng.pool.num_pages - 1 - pinned
    assert _run_one(b, longer) == want and b.prefix_hits == 1
    calls = []
    prefill, cont = eng.prefill, eng.prefill_continue
    eng.prefill = lambda *a, **k: calls.append(1) or prefill(*a, **k)
    eng.prefill_continue = lambda *a, **k: calls.append(2) or cont(*a, **k)
    assert _run_one(b, base) == first and b.prefix_hits == 2 and not calls
    eng.prefill, eng.prefill_continue = prefill, cont
    _run_one(b, [90, 91, 92, 93, 94, 95, 96, 97, 98])  # evicts the entry, pins its own
    for e in b._prefix.values():
        eng.release_snapshot(e["snap"])
    b._prefix.clear()
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert not any(eng.pool.refcount(p) for p in range(eng.pool.num_pages)) and first


def test_paged_prefix_streams_equal_jax():
    """The JAX paged batcher and the port's, both with a prefix cache and
    device-sampled chunks: the same hits, the same tokens (continuations at
    start_pos > 0 through the mp_cap-bounded page gather)."""
    jcfg, jp, tcfg, tp = build_pair(CFG, jnp.float32, seed=32)
    rng = np.random.default_rng(31)
    base = [[int(t) for t in rng.integers(3, CFG["vocab_size"], n)] for n in (20, 45)]
    out = []
    for eng, cls, B in ((JaxEngine(jp, jcfg, max_batch=4, seq_len=128, kv_layout="paged",
                                   page_size=16), JaxRequest, JaxBatcher),
                        (Engine(tp, tcfg, max_batch=4, seq_len=128, kv_layout="paged",
                                page_size=16, device="cpu"), Request, ContinuousBatcher)):
        b = B(eng, prefix_cache_size=4, max_chunk=4)
        first = [cls(prompt_tokens=p, steps=len(p) + 9, temperature=0.0, seed=5,
                     device_sampling=True) for p in base]
        second = [cls(prompt_tokens=base[0] + [7, 8, 9], steps=40, temperature=0.8, seed=6,
                      device_sampling=True),
                  cls(prompt_tokens=base[1], steps=60, temperature=0.0, seed=7,
                      device_sampling=True),
                  cls(prompt_tokens=base[1] + list(range(20, 40)), steps=80, temperature=0.0,
                      seed=8, device_sampling=True)]
        for wave in (first, second):
            for r in wave:
                b.submit(r)
            b.run()
        out.append(([r.out_tokens for r in first + second], b.prefix_hits))
    assert out[0] == out[1] and out[1][1] == 3


def test_full_pool_caches_no_prefix():
    """A pool that cannot spare a page for the boundary copy: the snapshot
    is None, the batcher stores no entry, and serving goes on."""
    want = _run_one(ContinuousBatcher(_tiny_engine()), [40, 41, 42], steps=64)
    eng = _tiny_engine(max_batch=1, num_pages=1 + 64 // 8)  # one request takes every page
    b = ContinuousBatcher(eng, prefix_cache_size=4)
    assert _run_one(b, [40, 41, 42], steps=64) == want and want
    assert not b._prefix and b.prefix_hits == 0
    assert _run_one(b, [40, 41, 42], steps=64) == want and b.prefix_hits == 0
    assert eng.pool.free_pages == eng.pool.num_pages - 1


def test_pool_direct_gate_raises():
    """An admission group above 8192 rows with T and the page size multiples
    of 256 is pool-direct, as in the JAX engine: one wave of 8 slots, 8
    chunks of 256 per layer through K16 and K17, no compact block (K15),
    and each request's pages reserved."""
    _, _, tcfg, tp = build_pair(dict(CFG, seq_len=2048), jnp.float32, seed=30)
    eng = Engine(tp, tcfg, max_batch=8, kv_layout="paged", page_size=256, device="cpu")
    _kernels.reset_counts()
    last = eng.prefill([[1] * 2000] * 8, list(range(8)))
    assert last.shape == (8, CFG["vocab_size"]) and np.isfinite(last).all()
    plain = _kernels.PLAIN_CALLS
    assert plain["K16"] == plain["K17"] == 8 * CFG["n_layers"] and plain["K15"] == 0
    assert eng.pool.free_pages == eng.pool.num_pages - 1 - 8 * 8
    small = _tiny_engine(max_batch=5, seq_len=2048, page_size=8)  # no: compact + chunked
    assert not engine_mod._pool_direct_ok(small.cache, 5, 2048)

"""Port parity for the pool-direct paged admission: K17
``kv_pool_write_chunk``, K16 ``paged_flash_prefill_attention``, K22
``paged_flash_decode_attention``, ``forward_prefill_paged_chunked`` and the
engine's admission waves (``prefill_into_slots_waved``), against the JAX
package on the CPU (its Pallas kernels in interpret mode, as
tests/test_paged_prefill.py runs them), on inputs made with numpy from a
seed.

Limits, and why:

* K17: byte-equal (a copy), the trash page included where one slot writes
  it.
* K16 against the JAX kernel: both round the scaled queries and p * vs to
  bf16 before the dots and the output to bf16 (csrc/prefill_mma.cuh).  At
  start 0 the JAX kernel's walk is its one fresh block, the plain version's
  one tile: K16_ONE_BLOCK_TOL = 1e-6 of max |jax| (readings 0 over seeds
  0-4 of these cases).  Past pages add the JAX kernel's online-softmax
  steps, per 8-row page, where the plain version follows the CUDA cell's
  64-key tiles: each rounds p * vs at its own running max, which can move
  an output by one bf16 step:
  K16_TOL = 2^-7 of max |jax|, one step of the largest output (readings up
  to 3.7e-3).  Against K6's plain version on a dense copy of the same keys,
  its output rounded to bf16: bit-equal (the same keys in the same order).
* K22 against the JAX kernel: 2^-8 of max |jax|, K13's limit in
  test_torch_paged.py (the same rounding points at ps <= 256, f32 sums in
  another order).
* ``forward_prefill_paged_chunked`` against JAX's: logits within FLASH_TOL
  (5e-2 of max |logit|), test_torch_prefill_chunked.py's limit for JAX's
  Pallas attention; pool rows (pages >= 1, the trash page 0 being written
  by several slots in no set order) of layer 0, which no attention feeds,
  int8-equal with scales within 8 f32 ulps (XLA's FMA contraction,
  test_torch_fused_quant.py).  Both K16s round q, p * vs and the output to
  bf16, but JAX's walks the pages with an online softmax and the plain
  version the CUDA cell's 64-key tiles, so an attention output moves by a
  bf16 step now and then, and every later layer's rows with it.  JAX's own
  compact path (``_prefill_into_slots``, f32 attention) parts from its
  pool-direct rows on more entries: the port's later rows may differ from
  JAX's pool-direct ones on at most LATER_SHARE = 0.6 of the share JAX's
  compact path does, by no more int8 steps.  Readings over token seeds 7
  and 8: 0.26-0.41 of it (dense 0.8% / 1 step against 2.9% / 1, GQA 1.5%
  / 1 against 3.8% / 1, fused 21% / 5 against 63% / 6); a K16 without its
  output rounding reads 0.73-0.99 and an f32 K16 1.0.  The JAX compact
  path's logits: FLASH_TOL too (readings up to 2.6e-2 of max |logit|, as
  far as JAX's own pool-direct path is from it).
* The port against itself: pool-direct (K16) against the compact path plus
  K15 with ``attn="flash"`` (K6), K6's output rounded to bf16 as K16's is:
  logits and pool rows bit-equal (K16 is K6 over the same keys in the same
  tiles); waves through ``start0`` against the one-shot call, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import TINY128, build_fused_pair
from test_torch_paged import _decode_case
from tpu_llama.models import llama as jl
from tpu_llama.ops import attention as jatt
from tpu_llama.runtime import ContinuousBatcher as JaxBatcher
from tpu_llama.runtime import Engine as JaxEngine
from tpu_llama.runtime import Request as JaxRequest
from tpu_llama.runtime import engine as jeng
from tpu_llama.runtime.paged import PagePool as JaxPagePool
from tpu_llama_torch import convert
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
from tpu_llama_torch.runtime import engine as teng

torch.set_num_threads(1)

K16_ONE_BLOCK_TOL = 1e-6
K16_TOL = 2.0 ** -7
K22_TOL = 2.0 ** -8
FLASH_TOL = 5e-2
LATER_SHARE = 0.6


# ---------------------------------------------------------------------------
# K17 kv_pool_write_chunk
# ---------------------------------------------------------------------------


def _write_case(seed, start, pt):
    rng = np.random.default_rng(seed)
    L, P, KVH, ps, hd, Tc = 3, 7, 2, 8, 12, 8
    B = len(start)
    rows = [rng.integers(-127, 128, (B, KVH, Tc, hd), dtype=np.int8) for _ in range(2)]
    rows += [rng.random((B, KVH, Tc)).astype(np.float32) for _ in range(2)]
    pool = [rng.integers(-127, 128, (L, P, KVH, ps, hd), dtype=np.int8) for _ in range(2)]
    pool += [rng.random((L, P, KVH, ps)).astype(np.float32) for _ in range(2)]
    return rows, np.asarray(pt, np.int32), np.asarray(start, np.int32), pool


# tests/test_paged_prefill.py's case (slot 1 writes its second page), and a
# start whose page column lies past the table (slot 0: the trash page 0)
WRITE_CASES = {"set": ([0, 8, 0], [[1, 2], [3, 4], [5, 6]]),
               "past_table": ([16, 8, 0], [[1, 2], [3, 4], [5, 6]])}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_k17_plain_equals_jax(case):
    rows, pt, start, pool = _write_case(5, *WRITE_CASES[case])
    want = jatt.kv_pool_write_chunk(*(jnp.asarray(a) for a in rows), jnp.asarray(pt),
                                    jnp.asarray(start), jnp.int32(1),
                                    *(jnp.asarray(a) for a in pool))
    tpool = [torch.tensor(a) for a in pool]
    before = _kernels.PLAIN_CALLS["K17"]
    got = tatt.kv_pool_write_chunk(*(torch.tensor(a) for a in rows), torch.tensor(pt),
                                   start.tolist(), 1, *tpool)
    assert _kernels.PLAIN_CALLS["K17"] == before + 1
    for g, orig, w, a in zip(got, tpool, want, pool):
        assert g is orig  # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "past_table":  # page 0 took slot 0's rows, its own pages nothing
        assert not np.array_equal(got[0].numpy()[1, 0], pool[0][1, 0])
        np.testing.assert_array_equal(got[0].numpy()[1, 1:3], pool[0][1, 1:3])


def test_k17_skips_what_jax_leaves_undefined():
    """A negative start, or a page id outside [0, P), writes nothing."""
    rows, pt, start, pool = _write_case(6, [-8, 0, 0], [[1, 2], [9, 4], [-1, 6]])
    tpool = [torch.tensor(a) for a in pool]
    tatt.kv_pool_write_chunk(*(torch.tensor(a) for a in rows), torch.tensor(pt), start, 2,
                             *tpool)
    for g, a in zip(tpool, pool):
        np.testing.assert_array_equal(g.numpy(), a)


def test_k17_rejects_chunks_that_cross_pages():
    rows, pt, start, pool = _write_case(7, [0, 8, 0], [[1, 2], [3, 4], [5, 6]])
    t = [torch.tensor(a) for a in rows]
    tpool = [torch.tensor(a) for a in pool]
    with pytest.raises(ValueError, match="start % Tc"):
        tatt.kv_pool_write_chunk(*t, torch.tensor(pt), [4, 8, 0], 1, *tpool)
    with pytest.raises(ValueError, match="ps % Tc"):  # chunks of 6 rows in pages of 8
        tatt.kv_pool_write_chunk(t[0][:, :, :6], t[1][:, :, :6], t[2][:, :, :6],
                                 t[3][:, :, :6], torch.tensor(pt), [0, 0, 0], 1, *tpool)
    with pytest.raises(ValueError):
        tatt.kv_pool_write_chunk(*t, torch.tensor(pt), [0, 8], 1, *tpool)
    with pytest.raises(ValueError):
        tatt.kv_pool_write_chunk(*t, torch.tensor(pt), [0, 8, 0], 3, *tpool)


# ---------------------------------------------------------------------------
# K16 paged_flash_prefill_attention
# ---------------------------------------------------------------------------


def _prefill_case(seed, G, start):
    """tests/test_paged_prefill.py's shapes: L 2, P 5, KVH 2, ps 8, hd 16,
    B 2, Tc 8, pages [[1, 2], [3, 4]]."""
    rng = np.random.default_rng(seed)
    L, P, KVH, ps, hd, B, Tc = 2, 5, 2, 8, 16, 2, 8
    q = rng.standard_normal((B, Tc, KVH * G, hd)).astype(np.float32)
    kp, vp = (rng.integers(-127, 128, (L, P, KVH, ps, hd), dtype=np.int8) for _ in range(2))
    ksp, vsp = (rng.uniform(0.005, 0.03, (L, P, KVH, ps)).astype(np.float32) for _ in range(2))
    pt = np.array([[1, 2], [3, 4]], np.int32)
    fk, fv = (rng.integers(-127, 128, (B, KVH, Tc, hd), dtype=np.int8) for _ in range(2))
    fks, fvs = (rng.uniform(0.005, 0.03, (B, KVH, Tc)).astype(np.float32) for _ in range(2))
    return q, kp, vp, ksp, vsp, pt, np.asarray(start, np.int32), fk, fv, fks, fvs


# (G, start): start 0, a partial page (5), full pages (16), GQA groups of 2 and 4
K16_CASES = [(1, [0, 0]), (1, [5, 16]), (2, [16, 5]), (4, [5, 0])]


@pytest.mark.parametrize("G,start", K16_CASES, ids=["start0", "partial-full", "G2", "G4"])
def test_k16_plain_matches_jax(G, start):
    arrs = _prefill_case(13 + G, G, start)
    want = np.asarray(jatt.paged_flash_prefill_attention(
        *(jnp.asarray(a) for a in arrs), layer=jnp.int32(1), past_pages=2), np.float32)
    before = _kernels.PLAIN_CALLS["K16"]
    got = tatt.paged_flash_prefill_attention(*(torch.tensor(a) for a in arrs), layer=1,
                                             past_pages=2)
    assert _kernels.PLAIN_CALLS["K16"] == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 8, 2 * G * 16)
    tol = K16_TOL if any(start) else K16_ONE_BLOCK_TOL
    assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("G,start", K16_CASES, ids=["start0", "partial-full", "G2", "G4"])
def test_k16_plain_equals_k6_plain_on_a_dense_copy(G, start):
    """K16 over the pool and the fresh rows is K6 over a dense cache that
    holds the past rows at [0, start) and the fresh rows at [start,
    start + Tc), its output rounded to bf16 as K16's is: the same keys in
    the same order, bit for bit."""
    q, kp, vp, ksp, vsp, pt, st, fk, fv, fks, fvs = _prefill_case(3 + G, G, start)
    B, Tc, KVH = 2, 8, 2
    S = 16 + Tc
    dense = [np.zeros((B, KVH, S) + a.shape[4:], a.dtype) for a in (kp, vp, ksp, vsp)]
    for b in range(B):
        for a, pool, fresh in zip(dense, (kp, vp, ksp, vsp), (fk, fv, fks, fvs)):
            rows = np.concatenate([pool[1, pt[b, j]] for j in range(2)], axis=1)  # [KVH, 16..]
            a[b, :, :st[b]] = rows[:, :st[b]]
            a[b, :, st[b]:st[b] + Tc] = fresh[b]
    got = tatt.paged_flash_prefill_attention(
        *(torch.tensor(a) for a in (q, kp, vp, ksp, vsp, pt, st, fk, fv, fks, fvs)), layer=1)
    d = [torch.tensor(a) for a in dense]
    want = tatt.flash_prefill_attention(torch.tensor(q), d[0], d[1], torch.tensor(st), d[2],
                                        d[3])
    assert torch.equal(got, want.to(torch.bfloat16).float())


def test_k16_keys_it_must_not_read_change_nothing():
    """Past rows at and past start, pages past past_pages, other slots'
    pages and page 0 may hold anything (int8 127, scale 1e9): the output
    does not change by one bit; a page id outside [0, P) reads page 0."""
    arrs = list(_prefill_case(21, 2, [5, 16]))
    base = tatt.paged_flash_prefill_attention(*(torch.tensor(a) for a in arrs), layer=1,
                                              past_pages=2)
    kp, vp, ksp, vsp, pt = arrs[1:6]
    live = np.zeros(kp.shape[1:4], bool)
    for b, s0 in enumerate([5, 16]):
        for s in range(s0):
            live[pt[b, s // 8], :, s % 8] = True
    for arr, val in ((kp, 127), (vp, 127), (ksp, 1e9), (vsp, 1e9)):
        arr[1][~live] = val
    wide = np.array([[1, 2, 0], [3, 4, 0]], np.int32)  # a third column past past_pages
    arrs[5] = wide
    again = tatt.paged_flash_prefill_attention(*(torch.tensor(a) for a in arrs), layer=1,
                                               past_pages=2)
    assert torch.equal(base, again)
    arrs[5] = np.array([[1, 2], [3, 4]], np.int32)
    arrs[6] = np.array([16, 16], np.int32)
    bad = arrs.copy()
    bad[5] = np.array([[1, 2], [3, 44]], np.int32)  # slot 1's second page: out of the pool
    zero = arrs.copy()
    zero[5] = np.array([[1, 2], [3, 0]], np.int32)
    a = tatt.paged_flash_prefill_attention(*(torch.tensor(x) for x in bad), layer=1)
    b = tatt.paged_flash_prefill_attention(*(torch.tensor(x) for x in zero), layer=1)
    assert torch.equal(a, b)


def test_k16_wrapper_checks():
    arrs = [torch.tensor(a) for a in _prefill_case(2, 1, [0, 0])]
    out = tatt.paged_flash_prefill_attention(*arrs, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tatt.paged_flash_prefill_attention(*arrs, past_pages=3)
    with pytest.raises(ValueError):
        tatt.paged_flash_prefill_attention(*arrs, layer=2)
    short = arrs.copy()
    short[0] = arrs[0][:, :4]
    with pytest.raises(ValueError):
        tatt.paged_flash_prefill_attention(*short)


# ---------------------------------------------------------------------------
# K22 paged_flash_decode_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 4])
def test_k22_plain_matches_jax(G):
    """K13's test shapes (tests/test_torch_paged.py): pages out of order
    and shared, pos 0, on a page boundary, inside a page, the last row of
    the table."""
    q, k, v, ks, vs, pt, pos, *_ = _decode_case(23 + G, G)
    arrs = (q, k, v, ks, vs, pt, pos)
    for layer in range(2):
        want = np.asarray(jatt.paged_flash_decode_attention(
            *(jnp.asarray(a) for a in arrs), layer=jnp.int32(layer)))
        before = _kernels.PLAIN_CALLS["K22"]
        got = tatt.paged_flash_decode_attention(*(torch.tensor(a) for a in arrs), layer=layer)
        assert _kernels.PLAIN_CALLS["K22"] == before + 1
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= K22_TOL * np.abs(want).max()


def test_k22_reads_rows_through_pos_only():
    """Rows past pos, other pages and page 0 may hold anything: the output
    does not change by one bit; the row AT pos is attended (write then
    attend); a negative pos attends nothing (zeros, as JAX's all-masked
    blocks give)."""
    q, k, v, ks, vs, pt, pos, *_ = _decode_case(4, 2)
    args = lambda: [torch.tensor(a) for a in (q, k, v, ks, vs, pt, pos)]
    base = tatt.paged_flash_decode_attention(*args(), layer=1)
    live = np.zeros(k.shape[1:4], bool)
    for b, p in enumerate(pos):
        for s in range(p + 1):
            live[pt[b, s // 16], :, s % 16] = True
    for arr, val in ((k, 127), (v, 127), (ks, 1e9), (vs, 1e9)):
        arr[1][~live] = val
    assert torch.equal(base, tatt.paged_flash_decode_attention(*args(), layer=1))
    neg = args()
    neg[6] = torch.tensor([-1, 16, 37, 63], dtype=torch.int32)
    out = tatt.paged_flash_decode_attention(*neg, layer=1)
    assert not out[0].any() and torch.equal(out[1:], base[1:])
    v[1, pt[1, 1], :, 0] = -v[1, pt[1, 1], :, 0]  # slot 1's row at its pos 16
    again = tatt.paged_flash_decode_attention(*args(), layer=1)
    assert not torch.equal(base[1], again[1]) and torch.equal(base[2:], again[2:])


# ---------------------------------------------------------------------------
# forward_prefill_paged_chunked
# ---------------------------------------------------------------------------


def _dense_pair(raw):
    """The same checkpoint through each package's params_from_raw (dense
    f32)."""
    traw = convert.raw_weights_from(raw)
    return raw.config, jl.params_from_raw(raw), traw.config, tl.params_from_raw(traw,
                                                                              device="cpu")


def _tables(B, ps, seq, reserve=None):
    """A page table from the JAX package's PagePool: each slot reserves
    ``reserve[b]`` positions (default: the whole context)."""
    mp = -(-seq // ps)
    pool = JaxPagePool(num_pages=B * mp + 1, page_size=ps, slots=B, max_pages_per_slot=mp)
    for s in range(B):
        assert pool.reserve(s, seq if reserve is None else reserve[s]) is not None
    return B * mp + 1, pool.table.copy()


def _paged_pair(jcfg, tcfg, B, ps, reserve=None):
    n, table = _tables(B, ps, jcfg.seq_len, reserve)
    jc = jl.make_kv_cache(jcfg, B, kv_dtype="int8", paged=True, num_pages=n, page_size=ps)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(table))
    tc = tl.make_kv_cache(tcfg, B, kv_dtype="int8", paged=True, num_pages=n, page_size=ps,
                          device="cpu")
    tc.page_table = torch.tensor(table)
    return jc, tc


def _pool_rows(cache):
    return [np.asarray(getattr(cache, a))[:, 1:] for a in ("k", "v", "ks", "vs")]


def _int8_readings(got, want):
    """(layer-0 share of int8 entries that differ, later layers' share,
    largest difference in int8 steps) over pages >= 1."""
    diff = [np.abs(g.astype(np.int32) - np.asarray(w).astype(np.int32))
            for g, w in zip(got[:2], want[:2])]
    return (float(np.mean([(d[0] != 0).mean() for d in diff])),
            float(np.mean([(d[1:] != 0).mean() for d in diff])) if diff[0].shape[0] > 1 else 0.0,
            int(max(d.max() for d in diff)))


def _layer0_equal(got, want):
    """Layer 0's rows (pages >= 1): int8 equal, scales within 8 f32 ulps
    (XLA contracts FMAs in the JAX package's fused passes,
    test_torch_fused_quant.py)."""
    for x, y in zip(got, want):
        if x.dtype == np.int8:
            np.testing.assert_array_equal(x[0], y[0])
        else:
            np.testing.assert_allclose(x[0], y[0], rtol=2.0 ** -20, atol=0)


def _model(name, request):
    if name == "fused":
        return build_fused_pair(dict(TINY128, seq_len=64), jnp.float32, seed=17)
    return _dense_pair(request.getfixturevalue(name))


# (weights, B, T, ps, chunk, lengths): the tiny dense f32 weights, the GQA
# ones (several pages: the past-page walk), and fused W8A8 at head_dim 128
# with B * chunk = 64 <= 2048 (JAX runs its fused body, _prefill_w8a8_fast_ok)
MODEL_CASES = [("tiny_weights", 2, 16, 16, 8, [16, 9]),
               ("tiny_gqa_weights", 2, 32, 8, 8, [32, 21]),
               ("fused", 2, 64, 32, 32, [64, 57])]


@pytest.mark.parametrize("name,B,T,ps,chunk,lengths", MODEL_CASES,
                         ids=[c[0] for c in MODEL_CASES])
def test_pool_direct_matches_jax(name, B, T, ps, chunk, lengths, request):
    """Against JAX's ``forward_prefill_paged_chunked`` (its K16 rounds q,
    p * vs and its output to bf16, as the port's does): logits within
    FLASH_TOL, layer-0 rows equal, later layers' rows no farther from its
    rows than the JAX engine's compact path (``_prefill_into_slots``: f32
    attention) is; that path's logits within FLASH_TOL too."""
    jcfg, jp, tcfg, tp = _model(name, request)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, jcfg.vocab_size, (B, T)).astype(np.int32)
    jc, tc = _paged_pair(jcfg, tcfg, B, ps)
    jargs = (jnp.asarray(toks), jnp.asarray(lengths), jnp.arange(B, dtype=jnp.int32), jcfg)
    direct, jc = jl.forward_prefill_paged_chunked(jp, jc, *jargs, chunk=chunk)
    compact, _, jcc = jeng._prefill_into_slots(jp, _paged_pair(jcfg, tcfg, B, ps)[0], *jargs,
                                               logits_mode="last")
    _kernels.reset_counts()
    got, tc2 = tl.forward_prefill_paged_chunked(tp, tc, torch.tensor(toks),
                                                torch.tensor(lengths), list(range(B)), tcfg,
                                                chunk=chunk)
    assert tc2 is tc
    L, n = tcfg.n_layers, T // chunk
    plain = _kernels.PLAIN_CALLS
    assert plain["K16"] == plain["K17"] == n * L and plain["K15"] == plain["K6"] == 0
    assert plain["K5"] == (n * L if name == "fused" else 0)
    got = got.numpy()
    for want in (direct, compact):
        want = np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= FLASH_TOL * np.abs(want).max()
    _rows_near_jax(_pool_rows(tc), _pool_rows(jc), _pool_rows(jcc))


def _rows_near_jax(rows, direct, compact):
    """The port's pool rows against JAX's pool-direct ones: layer 0 equal,
    later layers' int8 entries differing on at most LATER_SHARE of the share
    on which JAX's compact path differs from them, by no more steps."""
    _layer0_equal(rows, direct)
    _, later, steps = _int8_readings(rows, direct)
    _, jax_later, jax_steps = _int8_readings(compact, direct)
    assert later <= LATER_SHARE * jax_later and steps <= jax_steps, \
        (later, steps, jax_later, jax_steps)


@pytest.mark.parametrize("fuse", [False, True], ids=["dense", "fused"])
def test_pool_direct_equals_compact(fuse, tiny_gqa_weights, monkeypatch):
    """JAX's parity anchor on the port: the pool-direct prefill (K16)
    against the compact path plus K15 (``_prefill_into_slots`` with
    ``attn="flash"``: K6) on the same pool, K6's output rounded to bf16 as
    K16's is.  K16 is K6 over the same keys in the same tiles, so logits and
    pool rows are equal bit for bit."""
    if fuse:
        _, _, tcfg, tp = build_fused_pair(dict(TINY128, seq_len=64), jnp.float32, seed=9)
        B, T, ps, chunk = 2, 64, 32, 16
    else:
        _, _, tcfg, tp = _dense_pair(tiny_gqa_weights)
        B, T, ps, chunk = 2, 32, 8, 8
    rng = np.random.default_rng(11)
    toks = torch.tensor(rng.integers(3, tcfg.vocab_size, (B, T)))
    lengths = torch.tensor([T, T - 11])
    caches = []
    for _ in range(2):
        n, table = _tables(B, ps, tcfg.seq_len)
        c = tl.make_kv_cache(tcfg, B, kv_dtype="int8", paged=True, num_pages=n, page_size=ps,
                             device="cpu")
        c.page_table = torch.tensor(table)
        caches.append(c)
    k6 = tl.flash_prefill_attention
    monkeypatch.setattr(tl, "flash_prefill_attention", lambda *a, out_dtype=None: k6(
        *a, out_dtype=torch.bfloat16).to(out_dtype or torch.float32))
    _kernels.reset_counts()
    want, _ = teng._prefill_into_slots(tp, caches[0], toks, lengths, [0, 1], tcfg, attn="flash")
    got, _ = tl.forward_prefill_paged_chunked(tp, caches[1], toks, lengths, [0, 1], tcfg,
                                              chunk=chunk)
    assert _kernels.PLAIN_CALLS["K6"] == tcfg.n_layers
    assert torch.equal(got, want)
    for x, y in zip(_pool_rows(caches[1]), _pool_rows(caches[0])):
        np.testing.assert_array_equal(x, y)


def test_waves_through_start0_equal_the_one_shot_prefill(tiny_weights):
    """tests/test_paged_prefill.py's waved case: two waves of 16 positions
    (start0 0 and 16, max_pos 32) leave the pool the one-shot call leaves,
    and give its logits for every row whose last token lies in the last
    wave; a row that ends in the first wave takes its logits from that
    wave's call."""
    jcfg, _, tcfg, tp = _dense_pair(tiny_weights)
    B, T, ps, chunk, W = 3, 32, 8, 8, 16
    toks = torch.tensor(np.random.default_rng(31).integers(3, tcfg.vocab_size, (B, T)))
    lengths = torch.tensor([T, 27, 10])
    ca, cb = (_paged_pair(jcfg, tcfg, B, ps)[1] for _ in range(2))
    want, _ = tl.forward_prefill_paged_chunked(tp, ca, toks, lengths, [0, 1, 2], tcfg,
                                               chunk=chunk)
    waves = [tl.forward_prefill_paged_chunked(tp, cb, toks[:, w:w + W], lengths, [0, 1, 2],
                                              tcfg, chunk=chunk, start0=w, max_pos=T)[0]
             for w in range(0, T, W)]
    assert torch.equal(waves[1][:2], want[:2]) and torch.equal(waves[0][2], want[2])
    for a in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(ca, a), getattr(cb, a))


def test_pool_direct_guards(tiny_weights):
    jcfg, _, tcfg, tp = _dense_pair(tiny_weights)
    _, c = _paged_pair(jcfg, tcfg, 2, 16)  # 4 pages of 16 a slot
    toks, lengths = torch.ones(2, 16, dtype=torch.long), torch.tensor([16, 16])
    run = lambda **kw: tl.forward_prefill_paged_chunked(tp, c, toks, lengths, [0, 1], tcfg,
                                                        chunk=8, **kw)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        run(start0=4, max_pos=32)
    with pytest.raises(ValueError, match="max_pos"):
        run(start0=24, max_pos=32)
    with pytest.raises(ValueError, match="page table holds"):
        run(max_pos=80)
    with pytest.raises(ValueError):  # T not a multiple of the chunk
        tl.forward_prefill_paged_chunked(tp, c, toks[:, :12], lengths, [0, 1], tcfg, chunk=8)
    dense = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", device="cpu")
    with pytest.raises(TypeError):
        tl.forward_prefill_paged_chunked(tp, dense, toks, lengths, [0, 1], tcfg, chunk=8)
    run(start0=16, max_pos=64)  # the last wave of a 64-position prompt


# ---------------------------------------------------------------------------
# the engine's admission waves
# ---------------------------------------------------------------------------


@pytest.fixture
def small_gate(monkeypatch):
    """JAX's test_pool_direct_wave_admission thresholds on both engines:
    groups above 16 rows go pool-direct, in waves of 16 chunk rows (2 slots
    x chunks of 8)."""
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "_POOL_DIRECT_ROWS", 16)
        monkeypatch.setattr(mod, "_POOL_CHUNK", 8)
        monkeypatch.setattr(mod, "_WAVE_ROWS", 16)


def test_wave_admission_matches_jax(tiny_weights, small_gate):
    """JAX's test_pool_direct_wave_admission on both packages: two waves of
    two slots, each forced pool-direct; the limits of
    test_pool_direct_matches_jax against JAX's waves and its compact
    path."""
    jcfg, jp, tcfg, tp = _dense_pair(tiny_weights)
    B, T, ps = 4, 16, 16
    toks = np.random.default_rng(21).integers(3, jcfg.vocab_size, (B, T)).astype(np.int32)
    lengths = np.array([T, 9, T, 12], np.int32)
    jc, tc = _paged_pair(jcfg, tcfg, B, ps)
    jargs = (jnp.asarray(toks), jnp.asarray(lengths), jnp.arange(B, dtype=jnp.int32), jcfg)
    want, _, jc = jeng.prefill_into_slots_waved(jp, jc, *jargs)
    compact, _, jcc = jeng._prefill_into_slots(jp, _paged_pair(jcfg, tcfg, B, ps)[0], *jargs)
    _kernels.reset_counts()
    calls = []
    inner = teng.forward_prefill_paged_chunked
    teng.forward_prefill_paged_chunked = lambda p, c, t, *a, **k: \
        calls.append(t.shape[0]) or inner(p, c, t, *a, **k)
    try:
        got, _ = teng.prefill_into_slots_waved(tp, tc, torch.tensor(toks), torch.tensor(lengths),
                                               list(range(B)), tcfg)
    finally:
        teng.forward_prefill_paged_chunked = inner
    assert calls == [2, 2]  # two pool-direct waves of two slots
    L = tcfg.n_layers
    assert _kernels.PLAIN_CALLS["K16"] == 2 * 2 * L and _kernels.PLAIN_CALLS["K15"] == 0
    for w in (want, compact):
        w = np.asarray(w, np.float32)
        assert np.abs(got.numpy() - w).max() <= FLASH_TOL * np.abs(w).max()
    _rows_near_jax(_pool_rows(tc), _pool_rows(jc), _pool_rows(jcc))
    # below the gate: the compact path
    assert not teng._pool_direct_ok(tc, 1, 16) and teng._pool_direct_ok(tc, 2, 16)
    assert not teng._pool_direct_ok(tc, 4, 12)  # T not a multiple of the chunk


def _long_requests(cls):
    rng = np.random.default_rng(41)
    out = []
    for i, n in enumerate([30, 25, 18, 31, 12]):
        prompt = [int(v) for v in rng.integers(3, 320, n)]
        out.append(cls(prompt_tokens=prompt, steps=n + 1 + 6 + i, temperature=0.0,
                       seed=200 + i))
    return out


def test_batcher_pool_direct_streams_equal_jax(tiny_weights, small_gate):
    """A paged ContinuousBatcher whose admissions pass the (patched) gate:
    four prompts of 13-32 fed tokens admit as one pool-direct group of
    4 x 32 rows (two waves), the fifth later; greedy streams equal the JAX
    engine's, and the pool ends with every page free."""
    jcfg, jp, tcfg, tp = _dense_pair(tiny_weights)
    kw = dict(max_batch=4, seq_len=64, kv_layout="paged", page_size=16)
    jreqs = _long_requests(JaxRequest)
    jb = JaxBatcher(JaxEngine(jp, jcfg, **kw))
    for r in jreqs:
        jb.submit(r)
    jb.run()
    eng = Engine(tp, tcfg, device="cpu", **kw)
    _kernels.reset_counts()
    b = ContinuousBatcher(eng)
    treqs = _long_requests(Request)
    for r in treqs:
        b.submit(r)
    b.run()
    assert all(r.done for r in treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert _kernels.PLAIN_CALLS["K16"] > 0 and _kernels.PLAIN_CALLS["K17"] > 0
    assert eng.pool.free_pages == eng.pool.num_pages - 1
    assert not any(eng.pool.refcount(p) for p in range(eng.pool.num_pages))

"""Port parity for the deferred-flush decode attention: the plain versions
of K9 and K19 against the JAX package's ``flash_decode_attention_dma`` and
``flash_decode_attention_fresh`` (Pallas in interpret mode on the CPU), and
K10's plain version against ``kv_cache_flush_rows``.

K9 / K19 tolerance: max |port - jax| <= 2^-8 * max |jax|.  Both sides take
the same steps and round at the same places -- the scaled query to bf16 for
the cache score dot (exact products, f32 sums), p * vs to bf16 before the
PV dot (K9's p unnormalized within its key block, K19's normalized), the
fresh column in f32.  What differs is the order of the f32 sums (XLA's dots
against PyTorch's), a few f32 ulps in a score or a denominator.  Near a bf16
rounding boundary that can flip one p * vs by one bf16 step (2^-8 of that
term), and each output is a convex combination of V rows, so no output moves
by more than 2^-8 of max |out| even if every term flipped.
K10 is a copy: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import attention as jatt
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

TOL = 2.0 ** -8
POS = (0, 150, 255)  # empty slot, partial, full cache (S - 1)


def _case(seed, G, hd, L=2, B=3, KVH=2, S=256, pos=POS):
    """(q, k_cache, v_cache, pos, new_k, new_v, k_scale, v_scale, new_ks,
    new_vs) as numpy arrays, in the wrappers' argument order."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    k, v = (rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2))
    nk, nv = (rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, (L, B, KVH, S)).astype(np.float32) for _ in range(2))
    nks, nvs = (rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32) for _ in range(2))
    return q, k, v, np.asarray(pos, np.int32), nk, nv, ks, vs, nks, nvs


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("block_s", [16, 128])
@pytest.mark.parametrize("G,hd", [(1, 12), (2, 12), (1, 64), (2, 64)])
def test_k9_plain_matches_jax_kernel(G, hd, block_s):
    arrs = _case(9, G, hd)
    for layer in range(2):
        want = jatt.flash_decode_attention_dma(*(jnp.asarray(a) for a in arrs),
                                               layer=jnp.int32(layer), block_s=block_s)
        got = tatt.flash_decode_attention_dma(*(torch.tensor(a) for a in arrs), layer=layer,
                                              block_s=block_s)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)


@pytest.mark.parametrize("G,hd", [(1, 12), (2, 12), (1, 64), (2, 64)])
def test_k19_plain_matches_jax_kernel(G, hd):
    arrs = _case(19, G, hd)
    for layer in range(2):
        want = jatt.flash_decode_attention_fresh(*(jnp.asarray(a) for a in arrs), layer=layer)
        got = tatt.flash_decode_attention_fresh(*(torch.tensor(a) for a in arrs), layer=layer)
        assert got.dtype == torch.float32
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["dma", "fresh"])
def test_rows_at_and_beyond_pos_are_ignored(name):
    """Strict s < pos: rows at and past pos may hold anything (poisoned here
    with int8 127 and scale 1e9); the output does not change by one bit."""
    fn = getattr(tatt, f"flash_decode_attention_{name}")
    kw = dict(block_s=16) if name == "dma" else {}
    q, k, v, pos, nk, nv, ks, vs, nks, nvs = _case(4, 2, 16, pos=(0, 37, 200))
    base = fn(*(torch.tensor(a) for a in (q, k, v, pos, nk, nv, ks, vs, nks, nvs)), layer=1,
              **kw)
    for b, p in enumerate(pos):
        for arr, val in ((k, 127), (v, 127), (ks, 1e9), (vs, 1e9)):
            arr[1, b, :, p:] = val
    poisoned = fn(*(torch.tensor(a) for a in (q, k, v, pos, nk, nv, ks, vs, nks, nvs)),
                  layer=1, **kw)
    assert torch.equal(base, poisoned)


def test_dma_and_fresh_agree():
    """K9 and K19 compute one function with different rounding points
    (tests/test_attention.py:189 holds the JAX pair to 2e-2)."""
    arrs = [torch.tensor(a) for a in _case(5, 2, 64)]
    dma = tatt.flash_decode_attention_dma(*arrs, layer=0)
    fresh = tatt.flash_decode_attention_fresh(*arrs, layer=0)
    assert (dma - fresh).abs().max() <= 2e-2 * fresh.abs().max()


def _flush_case(seed, pos, L=2, B=3, KVH=2, S=64, hd=16):
    rng = np.random.default_rng(seed)
    rows = [rng.integers(-127, 128, (L, B, KVH, hd), dtype=np.int8) for _ in range(2)]
    rows_s = [rng.uniform(0, 1, (L, B, KVH)).astype(np.float32) for _ in range(2)]
    cache = [rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2)]
    cache_s = [rng.uniform(0, 1, (L, B, KVH, S)).astype(np.float32) for _ in range(2)]
    return rows, rows_s, cache, cache_s, np.asarray(pos, np.int32)


@pytest.mark.parametrize("pos", [[0, 8, 63], [17, 0, 40]])  # 0, an 8-row boundary, S - 1
def test_k10_plain_equals_jax(pos):
    rows, rows_s, cache, cache_s, p = _flush_case(len(pos) + pos[0], pos)
    want = jatt.kv_cache_flush_rows(
        jnp.asarray(rows[0]), jnp.asarray(rows[1]), jnp.asarray(p), jnp.asarray(cache[0]),
        jnp.asarray(cache[1]), jnp.asarray(rows_s[0]), jnp.asarray(rows_s[1]),
        jnp.asarray(cache_s[0]), jnp.asarray(cache_s[1]))
    ck, cv, cks, cvs = (torch.tensor(a) for a in (*cache, *cache_s))
    got = tatt.kv_cache_flush_rows(torch.tensor(rows[0]), torch.tensor(rows[1]),
                                   torch.tensor(p), ck, cv, torch.tensor(rows_s[0]),
                                   torch.tensor(rows_s[1]), cks, cvs)
    for g, orig, w in zip(got, (ck, cv, cks, cvs), want):
        assert g is orig  # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k10_skips_rows_outside_the_cache():
    """A slot whose pos lies outside [0, S) is never written (on the port
    alone: the JAX package's behaviour there is not part of the contract)."""
    S = 64
    rows, rows_s, cache, cache_s, p = _flush_case(3, [-1, S, 9], S=S)
    arrays = [torch.tensor(a) for a in (*cache, *cache_s)]
    tatt.kv_cache_flush_rows(torch.tensor(rows[0]), torch.tensor(rows[1]), torch.tensor(p),
                             arrays[0], arrays[1], torch.tensor(rows_s[0]),
                             torch.tensor(rows_s[1]), arrays[2], arrays[3])
    for got, before, row in zip(arrays, (*cache, *cache_s), (*rows, *rows_s)):
        want = before.copy()
        want[:, 2, :, 9] = row[:, 2]
        np.testing.assert_array_equal(got.numpy(), want)


def test_decode_wrappers_check_inputs_and_count():
    q, k, v, pos, nk, nv, ks, vs, nks, nvs = (torch.tensor(a) for a in _case(6, 1, 16))
    before = {n: _kernels.PLAIN_CALLS[n] for n in ("K9", "K10", "K19")}
    tatt.flash_decode_attention_dma(q, k, v, pos, nk, nv, ks, vs, nks, nvs, layer=1)
    tatt.flash_decode_attention_fresh(q, k, v, pos, nk, nv, ks, vs, nks, nvs, layer=1)
    rows = torch.zeros(2, 3, 2, 16, dtype=torch.int8)
    rows_s = torch.zeros(2, 3, 2)
    tatt.kv_cache_flush_rows(rows, rows, pos, k, v, rows_s, rows_s, ks, vs)
    assert all(_kernels.PLAIN_CALLS[n] == before[n] + 1 for n in before)
    for fn in (tatt.flash_decode_attention_dma, tatt.flash_decode_attention_fresh):
        with pytest.raises(ValueError, match="no scales"):  # an fp cache has none
            fn(q, k.float(), v.float(), pos, nk.float(), nv.float(), ks, vs, nks, nvs)
        with pytest.raises(ValueError):
            fn(q, k, v, pos, nk, nv, ks[..., :8], vs, nks, nvs)
        with pytest.raises(ValueError):
            fn(q, k, v, pos, nk, nv, ks, vs, nks, nvs, layer=2)
        with pytest.raises(ValueError):
            fn(q, k, v, pos, nk, nv)
        with pytest.raises(ValueError):  # one layer's cache, not the stacked [L, ...] one
            fn(q, k[0], v[0], pos, nk, nv, ks[0], vs[0], nks, nvs)
        with pytest.raises(TypeError):
            fn(q, k, v, pos, nk.float(), nv, ks, vs, nks, nvs)
    with pytest.raises(TypeError):  # int8 rows into an fp cache
        tatt.kv_cache_flush_rows(rows, rows, pos, k.float(), v.float())
    with pytest.raises(ValueError):
        tatt.kv_cache_flush_rows(rows[:, :2], rows[:, :2], pos, k, v, rows_s, rows_s, ks, vs)
    with pytest.raises(TypeError):
        tatt.kv_cache_flush_rows(rows, rows, pos, k, v, rows_s.double(), rows_s, ks, vs)

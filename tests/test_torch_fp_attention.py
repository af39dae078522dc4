"""Port parity for the fp-cache forms of K6, K7, K9, K19 and K10: the plain
versions against the JAX package's Pallas functions (interpret mode on the
CPU) on float32 and bfloat16 caches.

Tolerances: K6, K9 and K19 compute in f32 on both sides with nothing
rounded (attention.py:1613-1640, :274-295, :152-181): max |port - jax| <=
1e-5 * max |jax|, the order of f32 sums (XLA's dots against PyTorch's) and
one exp each.  K7 and K10 are copies: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import attention as jatt
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

TOL = 1e-5
CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
POS = (0, 150, 255)  # empty slot, partial, full cache (S - 1)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _pair(a, cache):
    """One numpy array as the JAX array and the port tensor of a cache
    dtype (bf16 values are rounded once, in JAX, and shared)."""
    j = jnp.asarray(a).astype(CACHE[cache][0])
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(CACHE[cache][1])
    return j, t


def _decode_case(seed, G, hd, cache, L=2, B=3, KVH=2, S=256):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    k, v = (_pair(rng.standard_normal((L, B, KVH, S, hd)), cache) for _ in range(2))
    nk, nv = (_pair(rng.standard_normal((B, KVH, hd)), cache) for _ in range(2))
    pos = np.asarray(POS, np.int32)
    jax_args = (jnp.asarray(q), k[0], v[0], jnp.asarray(pos), nk[0], nv[0])
    port_args = (torch.tensor(q), k[1], v[1], torch.tensor(pos), nk[1], nv[1])
    return jax_args, port_args


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("G,hd", [(1, 12), (2, 64)])
@pytest.mark.parametrize("name", ["dma", "fresh"])
def test_k9_k19_fp_plain_match_jax(name, G, hd, cache):
    """K9 (its fp key block of 64 rows, and 16) and K19 on an fp cache."""
    jargs, targs = _decode_case(9 if name == "dma" else 19, G, hd, cache)
    jfn = getattr(jatt, f"flash_decode_attention_{name}")
    tfn = getattr(tatt, f"flash_decode_attention_{name}")
    blocks = [None, 16] if name == "dma" else [None]
    form = _kernels.form("K9" if name == "dma" else "K19", CACHE[cache][1])
    for block_s in blocks:
        kw = {} if block_s is None else dict(block_s=block_s)
        for layer in range(2):
            before = _kernels.PLAIN_CALLS[form]
            want = jfn(*jargs, layer=jnp.int32(layer) if name == "dma" else layer, **kw)
            got = tfn(*targs, layer=layer, **kw)
            assert got.dtype == torch.float32 and _kernels.PLAIN_CALLS[form] == before + 1
            _close(got.numpy(), want)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_fp_decode_ignores_rows_at_and_beyond_pos(cache):
    """Strict s < pos on an fp cache: rows at and past pos poisoned with
    1e4 change no bit of K9's or K19's output."""
    _, targs = _decode_case(4, 2, 16, cache)
    q, k, v, pos, nk, nv = targs
    base = [tatt.flash_decode_attention_dma(*targs, layer=1),
            tatt.flash_decode_attention_fresh(*targs, layer=1)]
    for b, p in enumerate(POS):
        k[1, b, :, p:] = 1e4
        v[1, b, :, p:] = 1e4
    poisoned = [tatt.flash_decode_attention_dma(q, k, v, pos, nk, nv, layer=1),
                tatt.flash_decode_attention_fresh(q, k, v, pos, nk, nv, layer=1)]
    assert all(torch.equal(a, b) for a, b in zip(base, poisoned))


def _prefill_case(seed, B, T, NH, KVH, S, hd, start, cache):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, NH, hd)).astype(np.float32)
    k, v = (_pair(rng.standard_normal((B, KVH, S, hd)), cache) for _ in range(2))
    st = np.asarray(start, np.int32)
    return (jnp.asarray(q), k[0], v[0], jnp.asarray(st)), \
        (torch.tensor(q), k[1], v[1], torch.tensor(st))


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,NH,KVH,S,hd,start", [
    (2, 16, 4, 2, 16, 16, [0, 0]),       # start 0, the cache is the chunk (GQA 2)
    (2, 8, 2, 2, 64, 12, [5, 40]),       # start > 0 in a longer cache
    (1, 16, 8, 2, 128, 128, [100]),      # hd 128, GQA 4
], ids=["start0", "start>0", "hd128"])
def test_k6_fp_plain_matches_jax(B, T, NH, KVH, S, hd, start, cache):
    jargs, targs = _prefill_case(6, B, T, NH, KVH, S, hd, start, cache)
    form = _kernels.form("K6", CACHE[cache][1])
    before = _kernels.PLAIN_CALLS[form]
    want = jatt.flash_prefill_attention(*jargs)
    got = tatt.flash_prefill_attention(*targs)
    assert _kernels.PLAIN_CALLS[form] == before + 1
    _close(got.numpy(), want)
    out = tatt.flash_prefill_attention(*targs, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("T,S,slots", [(16, 64, [3, 0]), (128, 128, [1, 2, 0])])
def test_k7_fp_plain_equals_jax(T, S, slots, cache):
    rng = np.random.default_rng(T + S)
    L, KVH, hd, B = 2, 2, 16, 4
    n = len(slots)
    small = [_pair(rng.standard_normal((L, n, KVH, T, hd)), cache) for _ in range(2)]
    big = [_pair(rng.standard_normal((L, B, KVH, S, hd)), cache) for _ in range(2)]
    want = jatt.kv_cache_scatter_slots(small[0][0], small[1][0], jnp.asarray(slots, jnp.int32),
                                       big[0][0], big[1][0])
    ck, cv = big[0][1], big[1][1]
    got = tatt.kv_cache_scatter_slots(small[0][1], small[1][1], slots, ck, cv)
    assert len(got) == 2 and got[0] is ck and got[1] is cv  # written in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("pos", [[0, 8, 63], [17, 0, 40]])
def test_k10_fp_plain_equals_jax(pos, cache):
    rng = np.random.default_rng(len(pos) + pos[0])
    L, B, KVH, S, hd = 2, 3, 2, 64, 16
    rows = [_pair(rng.standard_normal((L, B, KVH, hd)), cache) for _ in range(2)]
    big = [_pair(rng.standard_normal((L, B, KVH, S, hd)), cache) for _ in range(2)]
    p = np.asarray(pos, np.int32)
    want = jatt.kv_cache_flush_rows(rows[0][0], rows[1][0], jnp.asarray(p), big[0][0],
                                    big[1][0])
    got = tatt.kv_cache_flush_rows(rows[0][1], rows[1][1], torch.tensor(p), big[0][1],
                                   big[1][1])
    assert len(got) == 2 and got[0] is big[0][1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w.astype(jnp.float32)))


def test_fp_wrappers_check_inputs():
    """fp caches take no scales and fresh rows of their own dtype; K12 and
    K18 stay INT8-only, as in JAX."""
    _, (q, k, v, pos, nk, nv) = _decode_case(3, 1, 16, "bf16")
    for fn in (tatt.flash_decode_attention_dma, tatt.flash_decode_attention_fresh):
        with pytest.raises(TypeError):  # fresh rows of another dtype
            fn(q, k, v, pos, nk.float(), nv.float())
        with pytest.raises(TypeError):  # K and V of different dtypes
            fn(q, k, v.float(), pos, nk, nv)
    with pytest.raises(TypeError):
        tatt.flash_decode_attention_dma(q, k.half(), v.half(), pos, nk.half(), nv.half())
    rows = torch.zeros(2, 3, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # scales with an fp cache
        tatt.kv_cache_flush_rows(rows, rows, pos, k, v, rows[..., 0].float(),
                                 rows[..., 0].float(), k[..., 0].float(), v[..., 0].float())
    with pytest.raises(TypeError):  # K18 is INT8-only
        tatt.kv_cache_write_chunk(k[0, :, :, :8], v[0, :, :, :8], k[0, :, :, :8, 0].float(),
                                  v[0, :, :, :8, 0].float(), 0, 0, k, v, k[..., 0].float(),
                                  v[..., 0].float())

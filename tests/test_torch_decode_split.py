"""The split decode cell of K9 and K13 (csrc/decode_split.cuh) on the CPU:
their plain versions at 1, 2 and 3 splits against the JAX package's
``flash_decode_attention_dma`` and ``paged_flash_decode_attention_dma``
(Pallas in interpret mode), the one-split form against the sequential block
walk it replaces, empty splits, the split rule, and K13 against K9 on a
paged copy.

Tolerances: INT8 caches 2^-8 of max |jax|, as
tests/test_torch_decode_attention.py, and for one more reason besides its
own: at more than one split each p is rounded, as bf16(p * vs), against its
split's running max instead of the whole walk's, which moves that term by
at most one bf16 step; an output is a convex combination of V rows, so no
output moves by more than 2^-8 of max |out|.  fp caches round nothing: 1e-5
of max |jax|, as tests/test_torch_fp_attention.py (the merge rescales in
another f32 order).  Everything else is bit for bit.
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
FP_TOL = 1e-5
POS = (0, 37, 150, 255)  # empty slot, inside the first span, inside a later one, S - 1
CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, G, hd, cache="int8", L=2, B=4, KVH=2, S=256, pos=POS):
    """(q, k, v, pos, new_k, new_v, k_scale, v_scale, new_ks, new_vs) as
    numpy arrays in the wrappers' order (the scales None for an fp cache,
    whose values are rounded to its dtype once, in JAX)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    if cache == "int8":
        k, v = (rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2))
        nk, nv = (rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, (L, B, KVH, S)).astype(np.float32) for _ in range(2))
        nks, nvs = (rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32) for _ in range(2))
    else:
        def rnd(*shape):
            x = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
            return np.asarray(x.astype(CACHE[cache][0]).astype(jnp.float32))

        k, v, nk, nv = rnd(L, B, KVH, S, hd), rnd(L, B, KVH, S, hd), rnd(B, KVH, hd), \
            rnd(B, KVH, hd)
        ks = vs = nks = nvs = None
    return q, k, v, np.asarray(pos, np.int32), nk, nv, ks, vs, nks, nvs


def _torch(arrs, cache="int8"):
    out = [None if a is None else torch.tensor(a) for a in arrs]
    if cache != "int8":
        for i in (1, 2, 4, 5):  # k, v, new_k, new_v in the cache's dtype
            out[i] = out[i].to(CACHE[cache][1])
    return out


def _jax(arrs, cache="int8"):
    out = [None if a is None else jnp.asarray(a) for a in arrs]
    if cache != "int8":
        for i in (1, 2, 4, 5):
            out[i] = out[i].astype(CACHE[cache][0])
        out = out[:6]  # an fp cache has no scales
    return out


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _sequential_walk(q, k_cache, v_cache, pos, new_k, new_v, k_scale=None, v_scale=None,
                     new_ks=None, new_vs=None, layer=0, ts=128):
    """The one-block-per-(slot, kv head) walk the split cell replaced: the
    online softmax over every key block of ``ts`` rows in order, then the
    fresh column (the plain version of K9 before the split)."""
    int8 = k_scale is not None
    qs = tatt._scaled_q(q)
    qb = qs.to(torch.bfloat16).float() if int8 else qs
    B, KVH, G, hd = qb.shape
    S = k_cache.shape[3]
    kc, vc = k_cache[layer], v_cache[layer]
    p = pos.long()[:, None, None, None]
    m = torch.full((B, KVH, G), -1e30)
    l = torch.zeros((B, KVH, G))
    acc = torch.zeros((B, KVH, G, hd))
    for base in range(0, S, ts):
        rows = slice(base, base + ts)
        s = torch.einsum("bkgd,bksd->bkgs", qb, kc[:, :, rows].float())
        if int8:
            s = s * k_scale[layer][:, :, None, rows]
        valid = torch.arange(base, base + ts)[None, None, None, :] < p
        m_new = torch.maximum(m, torch.where(valid, s, -1e30).amax(-1))
        corr = torch.exp(m - m_new)
        pr = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + pr.sum(-1)
        if int8:
            pr = (pr * v_scale[layer][:, :, None, rows]).to(torch.bfloat16).float()
        acc = acc * corr[..., None] + torch.einsum("bkgs,bksd->bkgd", pr, vc[:, :, rows].float())
        m = m_new
    s_new = torch.einsum("bhgd,bhd->bhg", qs, new_k.float())
    nv = new_v.float()
    if int8:
        s_new = s_new * new_ks[:, :, None]
        nv = nv * new_vs[..., None]
    m_fin = torch.maximum(m, s_new)
    corr = torch.exp(m - m_fin)
    e_new = torch.exp(s_new - m_fin)
    l_fin = l * corr + e_new
    return ((acc * corr[..., None] + e_new[..., None] * nv[:, :, None, :])
            / torch.clamp_min(l_fin, 1e-30)[..., None])


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("G,hd", [(1, 16), (2, 64)])
def test_k9_int8_splits_match_jax(G, hd, splits):
    """16 key blocks of 16 rows: spans of 16, 8 + 8, 5 + 5 + 6."""
    arrs = _case(90 + G, G, hd)
    for layer in range(2):
        want = jatt.flash_decode_attention_dma(*_jax(arrs), layer=jnp.int32(layer), block_s=16)
        got = tatt.flash_decode_attention_dma(*_torch(arrs), layer=layer, block_s=16,
                                              splits=splits)
        assert got.dtype == torch.float32
        _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_k9_fp_splits_match_jax(cache, splits):
    arrs = _case(93, 2, 64, cache)
    form = _kernels.form("K9", CACHE[cache][1])
    before = _kernels.PLAIN_CALLS[form]
    want = jatt.flash_decode_attention_dma(*_jax(arrs, cache), layer=jnp.int32(1), block_s=16)
    got = tatt.flash_decode_attention_dma(*_torch(arrs, cache), layer=1, block_s=16,
                                          splits=splits)
    assert _kernels.PLAIN_CALLS[form] == before + 1
    _close(got.numpy(), want, FP_TOL)


def _paged_case(seed, G, hd=16, L=2, B=4, KVH=2, ps=16, MP=8, pos=(0, 21, 70, 127)):
    """(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k, new_v,
    new_ks, new_vs) as numpy arrays: each slot's MP pages drawn out of order
    from a pool of B * MP + 1 (page 0 unused), and the dense cache the
    pages hold ([L, B, KVH, MP * ps, hd], for K9)."""
    rng = np.random.default_rng(seed)
    P = B * MP + 1
    S = MP * ps
    dense = [rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2)] + \
        [rng.uniform(0.005, 0.03, (L, B, KVH, S)).astype(np.float32) for _ in range(2)]
    pt = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    pool = [np.zeros((L, P, KVH, ps) + a.shape[4:], a.dtype) for a in dense]
    for a, d in zip(pool, dense):
        for b in range(B):
            for j in range(MP):
                a[:, pt[b, j]] = d[:, b, :, j * ps:(j + 1) * ps]
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    nk, nv = (rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8) for _ in range(2))
    nks, nvs = (rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32) for _ in range(2))
    paged = (q, *pool, pt, np.asarray(pos, np.int32), nk, nv, nks, nvs)
    return paged, dense


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("G", [1, 4])
def test_k13_splits_match_jax(G, splits):
    """8 key blocks of 16 rows (one page each): spans of 8, 4 + 4, 2 + 3 +
    3."""
    paged, _ = _paged_case(130 + G, G)
    for layer in range(2):
        want = jatt.paged_flash_decode_attention_dma(*(jnp.asarray(a) for a in paged),
                                                     layer=jnp.int32(layer))
        got = tatt.paged_flash_decode_attention_dma(*(torch.tensor(a) for a in paged),
                                                    layer=layer, splits=splits)
        _close(got.numpy(), want, TOL)


@pytest.mark.parametrize("cache", ["int8", "f32", "bf16"])
def test_one_split_is_the_sequential_walk(cache):
    """At one split the plain version is the walk it replaced, bit for bit."""
    t = _torch(_case(5, 2, 16, cache), cache)
    got = tatt.flash_decode_attention_dma(*t, layer=1, block_s=16, splits=1)
    assert torch.equal(got, _sequential_walk(*t, layer=1, ts=16))


def test_k13_one_split_is_the_sequential_walk():
    paged, dense = _paged_case(7, 2)
    t = [torch.tensor(a) for a in paged]
    d = [torch.tensor(a) for a in dense]
    got = tatt.paged_flash_decode_attention_dma(*t, layer=1, splits=1)
    q, pos, nk, nv, nks, nvs = t[0], t[6], t[7], t[8], t[9], t[10]
    want = _sequential_walk(q, d[0], d[1], pos, nk, nv, d[2], d[3], nks, nvs, layer=1, ts=16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("cache", ["int8", "f32"])
def test_empty_splits(cache, splits):
    """A slot at pos 0 (every split empty) gives the fresh column alone;
    a slot whose rows all lie in the first span (every later split empty)
    gives the one-split result, both bit for bit; all finite."""
    q, k, v, pos, nk, nv, ks, vs, nks, nvs = t = _torch(_case(11, 2, 16, cache), cache)
    got = tatt.flash_decode_attention_dma(*t, layer=0, block_s=16, splits=splits)
    one = tatt.flash_decode_attention_dma(*t, layer=0, block_s=16, splits=1)
    assert torch.isfinite(got).all()
    fresh = nv[0].float() * (nvs[0][:, None] if cache == "int8" else 1.0)
    assert torch.equal(got[0], fresh[:, None, :].expand(-1, got.shape[2], -1))
    first = tatt.split_spans(k.shape[3], 16, splits)[0][1]
    assert 0 < int(pos[1]) <= first
    assert torch.equal(got[1], one[1])


@pytest.mark.parametrize("splits", [1, 2, 3, None])
def test_k13_equals_k9_on_a_paged_copy(splits):
    """K13's plain version on the pages equals K9's on the dense cache they
    hold, bit for bit, at equal key blocks and splits (None: the rule, which
    gives both the same count for rows_max = MP * ps)."""
    paged, dense = _paged_case(17, 2, MP=40, pos=(0, 300, 517, 639))  # rows_max 640 > 512
    t = [torch.tensor(a) for a in paged]
    d = [torch.tensor(a) for a in dense]
    q, pos, nk, nv, nks, nvs = t[0], t[6], t[7], t[8], t[9], t[10]
    got = tatt.paged_flash_decode_attention_dma(*t, layer=1, splits=splits)
    k9 = tatt.flash_decode_attention_dma(q, d[0], d[1], pos, nk, nv, d[2], d[3], nks, nvs,
                                         layer=1, block_s=16, splits=splits)
    assert torch.equal(got, k9)
    if splits is None:  # B 4 x KVH 2 = 8 cells: the rule splits 40 blocks in 20 (of two)
        assert tatt.decode_splits(4, 2, 16, 640) == 20
        assert not torch.equal(got, tatt.paged_flash_decode_attention_dma(*t, layer=1,
                                                                          splits=1))


def test_split_rule():
    """One split wherever B * KVH >= 132 or rows_max <= 512; elsewhere at
    most 264 blocks in all (two an SM) and each split at least two key
    blocks; the rule is a function of (B, KVH,
    TS, rows_max) alone, so a pool of MP pages of ps rows splits as a dense
    cache of MP * ps rows."""
    rule = tatt.decode_splits
    for B in (1, 2, 3, 4, 8, 16, 32, 64):
        for KVH in (1, 2, 4, 8, 16, 32, 40, 64):
            for ts in (16, 64, 128, 256):
                for rows in (64, 256, 512, 513, 1024, 2048, 4096, 8192):
                    n = rule(B, KVH, ts, rows)
                    if B * KVH >= 132 or rows <= 512:
                        assert n == 1
                        continue
                    blocks = -(-rows // ts)
                    assert 1 <= n and (n == 1 or B * KVH * n <= 264)
                    spans = tatt.split_spans(rows, ts, n)
                    assert all(r1 - r0 >= min(2 * ts, rows) for r0, r1 in spans)
                    assert spans[0][0] == 0 and spans[-1][1] == rows
                    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
                    assert n == 1 or n <= blocks // 2
    # the shapes of the 7B table: B 1 at S 2048 splits in 8 (blocks of 128
    # rows) or 4 (of 256, K13's), B 8 KVH 8 in 4; the 7B batch-8 and 32
    # steps in 1; 4i's tp = 2 (KVH 16 a rank) in 2
    assert rule(1, 32, 128, 2048) == 8 and rule(1, 32, 256, 2048) == 4
    assert rule(8, 8, 128, 2048) == 4 and rule(8, 8, 256, 2048) == 4
    assert rule(8, 32, 128, 2048) == 1 and rule(32, 32, 256, 2048) == 1
    assert rule(8, 16, 128, 2048) == 2
    # K13 asks the rule with its own block and MP * ps, as K9 with that block
    q = torch.zeros(1, 32, 1, 128)
    pool = torch.zeros(1, 5, 32, 512, 128, dtype=torch.int8)
    assert tatt._paged_splits(q, pool, torch.zeros(1, 4, dtype=torch.int32), None) == \
        rule(1, 32, 256, 2048)


def test_splits_argument():
    """``splits`` None is the rule's count; anything but a positive int is
    refused."""
    t = _torch(_case(3, 1, 16, S=1024, pos=(0, 700, 900, 1023)))
    assert tatt.decode_splits(4, 2, 128, 1024) == 4
    assert torch.equal(tatt.flash_decode_attention_dma(*t, layer=0),
                       tatt.flash_decode_attention_dma(*t, layer=0, splits=4))
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="splits"):
            tatt.flash_decode_attention_dma(*t, layer=0, splits=bad)
    paged, _ = _paged_case(4, 1)
    with pytest.raises(ValueError, match="splits"):
        tatt.paged_flash_decode_attention_dma(*(torch.tensor(a) for a in paged), splits=0)

"""The normalized split decode cell of K19 and K21's single-pass form
(csrc/decode_split_norm.cuh) on the CPU: their plain versions at 1, 2, 4
and 8 splits of the key rows against the JAX package's
``flash_decode_attention_fresh`` and ``flash_decode_attention`` (Pallas in
interpret mode), the one-split form against the single-pass sums it
replaces, poisoned rows, the edge positions, empty splits, the split rule
and the ``splits`` argument.

Tolerances: INT8 caches 2^-8 of max |jax|, as
tests/test_torch_decode_attention.py and tests/test_torch_tp_kernels.py.
The splits move no rounding point: p is normalized by the global max and
denominator before it is rounded, as bf16(p * vs), at every count; only the
f32 order of the denominator's sum and of the PV partials moves, a few ulps
that near a bf16 boundary can flip one p * vs by one bf16 step (2^-8 of that
term), and an output is a convex combination of V rows.  fp caches round
nothing: 2^-16 of max |jax|.  Everything else is bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import attention as jatt
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

TOL = 2.0 ** -8
FP_TOL = 2.0 ** -16
S = 1024  # 8 ring tiles of 128 rows (INT8), 16 of 64 (fp): every one of 8 splits has rows
POS = (0, 500, S - 1)  # K19: an empty slot, mid-cache (inside the fourth of eight spans), all
CACHES = {"int8": None, "f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SPLITS = (1, 2, 4, 8)
SHAPES = ((1, 16), (4, 16), (1, 128), (4, 128))  # (G, hd)


def _case(seed, cache, G, hd, pos=POS, L=2, KVH=2, S=S):
    """(q, k, v, pos, new_k, new_v, k_scale, v_scale, new_ks, new_vs) as
    numpy arrays (the scales None for an fp cache, whose values are rounded
    to its dtype once); B = len(pos)."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    if cache == "int8":
        k, v = (rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2))
        nk, nv = (rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, (L, B, KVH, S)).astype(np.float32) for _ in range(2))
        nks, nvs = (rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32) for _ in range(2))
    else:
        def rnd(*shape):
            x = torch.tensor(rng.standard_normal(shape).astype(np.float32))
            return x.to(CACHES[cache][1]).float().numpy()

        k, v, nk, nv = rnd(L, B, KVH, S, hd), rnd(L, B, KVH, S, hd), rnd(B, KVH, hd), \
            rnd(B, KVH, hd)
        ks = vs = nks = nvs = None
    return q, k, v, np.asarray(pos, np.int32), nk, nv, ks, vs, nks, nvs


def _torch(arrs, cache):
    out = [None if a is None else torch.tensor(a) for a in arrs]
    if cache != "int8":
        for i in (1, 2, 4, 5):  # k, v, new_k, new_v in the cache's dtype
            out[i] = out[i].to(CACHES[cache][1])
    return out


def _jax(arrs, cache):
    out = [None if a is None else jnp.asarray(a) for a in arrs]
    if cache != "int8":
        for i in (1, 2, 4, 5):
            out[i] = out[i].astype(CACHES[cache][0])
    return out


def _k21(t):
    """K21's arguments (q, k, v, pos, k_scale, v_scale) out of a case."""
    return t[0], t[1], t[2], t[3], t[6], t[7]


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_out(kernel, cache, G, hd, layer):
    """The JAX function's output on the case (kept across split counts)."""
    j = _jax(_case(16 + G + hd, cache, G, hd), cache)
    if kernel == "K19":
        return np.asarray(jatt.flash_decode_attention_fresh(*j, layer=layer))
    return np.asarray(jatt.flash_decode_attention(j[0], j[1], j[2], j[3], j[6], j[7],
                                                  layer=jnp.int32(layer)))


def _single_pass_k19(q, k_cache, v_cache, pos, new_k, new_v, k_scale=None, v_scale=None,
                     new_ks=None, new_vs=None, layer=0):
    """K19's plain version before the split cell: one softmax over all S rows
    masked to s < pos, its sums over the whole row."""
    S_ = k_cache.shape[3]
    kc, vc = k_cache[layer], v_cache[layer]
    int8 = k_scale is not None
    qs = q.float() / tatt.sqrt_f32(q.shape[-1])
    s = torch.einsum("bkgd,bksd->bkgs", tatt._bf16(qs) if int8 else qs, kc.float())
    s_new = (qs * new_k.float()[:, :, None, :]).sum(-1)
    if int8:
        s = s * k_scale[layer][:, :, None, :]
        s_new = s_new * new_ks[:, :, None]
    valid = torch.arange(S_)[None, None, None, :] < pos.long()[:, None, None, None]
    s = torch.where(valid, s, -1e30)
    m = torch.maximum(s.amax(-1), s_new)
    e = torch.exp(s - m[..., None])
    e_new = torch.exp(s_new - m)
    l = e.sum(-1) + e_new
    pr = e / l[..., None]
    p_new = e_new / l
    if int8:
        pr = tatt._bf16(pr * v_scale[layer][:, :, None, :])
        p_new = p_new * new_vs[:, :, None]
    return (torch.einsum("bkgs,bksd->bkgd", pr, vc.float())
            + p_new[..., None] * new_v.float()[:, :, None, :])


def _single_pass_k21(q, k_cache, v_cache, pos, k_scale=None, v_scale=None, layer=0):
    """K21's single-pass plain version before the split cell."""
    qs = q.float() / tatt.sqrt_f32(q.shape[-1])
    int8 = k_cache.dtype == torch.int8
    qb = tatt._bf16(qs) if int8 else qs
    S_ = k_cache.shape[3]
    kc, vc = k_cache[layer], v_cache[layer]
    s = torch.einsum("bkgd,bksd->bkgs", qb, kc.float())
    if int8:
        s = s * k_scale[layer][:, :, None, :]
    valid = torch.arange(S_)[None, None, None, :] <= pos.long()[:, None, None, None]
    s = torch.where(valid, s, -1e30)
    e = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    pr = e / torch.clamp_min(e.sum(-1, keepdim=True), 1e-30)
    if int8:
        pr = tatt._bf16(pr * v_scale[layer][:, :, None, :])
    return torch.einsum("bkgs,bksd->bkgd", pr, vc.float())


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("G,hd", SHAPES)
def test_k19_splits_match_jax(G, hd, cache, splits):
    t = _torch(_case(16 + G + hd, cache, G, hd), cache)
    form = _kernels.form("K19", t[1].dtype)
    before = _kernels.PLAIN_CALLS[form]
    for layer in range(2):
        got = tatt.flash_decode_attention_fresh(*t, layer=layer, splits=splits)
        assert got.dtype == torch.float32
        _close(got.numpy(), _jax_out("K19", cache, G, hd, layer),
               TOL if cache == "int8" else FP_TOL)
    assert _kernels.PLAIN_CALLS[form] == before + 2


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("G,hd", SHAPES)
def test_k21_splits_match_jax(G, hd, cache, splits):
    """K21 attends s <= pos: slots at 0 (one row), mid-cache and S - 1."""
    t = _torch(_case(16 + G + hd, cache, G, hd), cache)
    form = _kernels.form("K21", t[1].dtype)
    before = _kernels.PLAIN_CALLS[form]
    for layer in range(2):
        got = tatt.flash_decode_attention(*_k21(t), layer=layer, splits=splits)
        _close(got.numpy(), _jax_out("K21", cache, G, hd, layer),
               TOL if cache == "int8" else FP_TOL)
    assert _kernels.PLAIN_CALLS[form] == before + 2


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("G,hd", [(1, 16), (4, 128)])
def test_one_split_is_the_single_pass(G, hd, cache):
    """At one split each plain version is the single-pass version it
    replaced, bit for bit; more splits part from it by the f32 order alone."""
    t = _torch(_case(3 + G, cache, G, hd), cache)
    k19 = tatt.flash_decode_attention_fresh_plain(*t, layer=1, splits=1)
    assert torch.equal(k19, _single_pass_k19(*t, layer=1))
    k21 = tatt.flash_decode_attention_plain(*_k21(t), layer=1, splits=1)
    assert torch.equal(k21, _single_pass_k21(*_k21(t), layer=1))
    tol = TOL if cache == "int8" else FP_TOL
    for n in (2, 4, 8):
        _close(tatt.flash_decode_attention_fresh_plain(*t, layer=1, splits=n), k19, tol)
        _close(tatt.flash_decode_attention_plain(*_k21(t), layer=1, splits=n), k21, tol)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("cache", list(CACHES))
def test_rows_not_attended_are_ignored(cache, splits):
    """Every row at and past a slot's pos (K19; past it for K21) set to 127
    with scale 1e4 (INT8) or to 1e4 (fp) changes no bit of the output."""
    arrs = _case(7, cache, 2, 16)
    clean = _torch(arrs, cache)
    poisoned = [None if a is None else a.copy() for a in arrs]
    k, v, ks, vs = poisoned[1], poisoned[2], poisoned[6], poisoned[7]
    for b, p in enumerate(POS):
        for a, val in ((k, 127 if ks is not None else 1e4), (v, 127 if ks is not None else 1e4),
                       (ks, 1e4), (vs, 1e4)):
            if a is not None:
                a[:, b, :, p:] = val
    bad = _torch(poisoned, cache)
    assert torch.equal(tatt.flash_decode_attention_fresh(*clean, layer=1, splits=splits),
                       tatt.flash_decode_attention_fresh(*bad, layer=1, splits=splits))
    for b, p in enumerate(POS):  # K21 reads row pos too: keep it clean
        for i in (1, 2, 6, 7):
            if bad[i] is not None:
                bad[i][:, b, :, p] = clean[i][:, b, :, p]
    assert torch.equal(tatt.flash_decode_attention(*_k21(clean), layer=1, splits=splits),
                       tatt.flash_decode_attention(*_k21(bad), layer=1, splits=splits))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("cache", list(CACHES))
def test_edge_positions(cache, splits):
    """K19 at pos 0 gives the fresh column alone; K21 at a negative pos
    attends nothing (zeros); both finite."""
    q, k, v, pos, nk, nv, ks, vs, nks, nvs = t = _torch(_case(11, cache, 2, 16, pos=(0, 300)),
                                                        cache)
    got = tatt.flash_decode_attention_fresh(*t, layer=0, splits=splits)
    assert torch.isfinite(got).all()
    fresh = nv[0].float() * (nvs[0][:, None] if cache == "int8" else 1.0)
    assert torch.equal(got[0], fresh[:, None, :].expand(-1, got.shape[2], -1))
    neg = torch.tensor([-1, 300], dtype=torch.int32)
    out = tatt.flash_decode_attention(q, k, v, neg, ks, vs, layer=0, splits=splits)
    assert torch.isfinite(out).all()
    assert torch.count_nonzero(out[0]) == 0
    assert torch.count_nonzero(out[1]) > 0


@pytest.mark.parametrize("cache", ["int8", "f32"])
def test_empty_splits(cache):
    """Over 256 rows (two ring tiles for INT8, four for fp) eight splits
    leave spans empty; empty spans add exact zeros, so eight splits equal
    the count that has no empty span, bit for bit."""
    t = _torch(_case(13, cache, 2, 16, pos=(0, 37, 200, 255), S=256), cache)
    full = 2 if cache == "int8" else 4
    spans = tatt.split_spans(256, tatt._norm_block(256, t[1].element_size()), 8)
    assert sum(r1 == r0 for r0, r1 in spans) == 8 - full
    assert torch.equal(tatt.flash_decode_attention_fresh(*t, layer=1, splits=8),
                       tatt.flash_decode_attention_fresh(*t, layer=1, splits=full))
    assert torch.equal(tatt.flash_decode_attention(*_k21(t), layer=1, splits=8),
                       tatt.flash_decode_attention(*_k21(t), layer=1, splits=full))


def test_norm_split_rule():
    """K9's rule capped at one cluster of 8: at the 7B table's shapes K19
    splits 1 / 4 / 8 / 8 (B8 KVH32, B8 KVH8 G4, B1 at pos 511 and 2047: the
    rule reads shapes, not positions), K21 at tp 1 / 2 / 4 / 8 (KVH 32 / tp
    at B8) 1 / 2 / 4 / 8 and at B32 1; fp caches' 64-row tiles alike; the
    cap where K9's rule goes past 8; the ring tile 128 rows for INT8, 64
    for fp, or S when shorter."""
    rule = tatt.norm_splits
    assert [rule(8, 32, 128, 2048), rule(8, 8, 128, 2048), rule(1, 32, 128, 2048)] == [1, 4, 8]
    assert [rule(8, 32 // tp, 128, 2048) for tp in (1, 2, 4, 8)] == [1, 2, 4, 8]
    assert rule(32, 32, 128, 2048) == 1
    assert rule(1, 32, 64, 2048) == 8 and rule(8, 32, 64, 2048) == 1
    assert tatt.decode_splits(1, 8, 128, 4096) == 16 and rule(1, 8, 128, 4096) == 8
    assert rule(1, 32, 128, 512) == 1  # short caches stay whole
    for B in (1, 2, 4, 8, 32):
        for KVH in (1, 4, 8, 32):
            for rows in (64, 512, 1024, 2048, 8192):
                assert 1 <= rule(B, KVH, 128, rows) <= tatt.NORM_SPLITS_MAX
    assert [tatt._norm_block(2048, n) for n in (1, 4, 2)] == [128, 64, 64]
    assert tatt._norm_block(100, 1) == 100 and tatt._norm_block(1000, 1) == 128


def test_splits_argument():
    """``splits`` None is the rule's count; anything but an int in [1, 8] is
    refused, on the CPU as on the card; K21's blocked form takes none."""
    t = _torch(_case(5, "int8", 1, 16, pos=(0, 900)), "int8")
    n = tatt.norm_splits(2, 2, 128, S)
    assert n == 4  # eight tiles of 128 rows, each split at least two
    assert torch.equal(tatt.flash_decode_attention_fresh(*t, layer=0),
                       tatt.flash_decode_attention_fresh(*t, layer=0, splits=n))
    assert torch.equal(tatt.flash_decode_attention(*_k21(t), layer=0),
                       tatt.flash_decode_attention(*_k21(t), layer=0, splits=n))
    for bad in (0, -1, 1.5, 9):
        with pytest.raises(ValueError, match="splits"):
            tatt.flash_decode_attention_fresh(*t, layer=0, splits=bad)
        with pytest.raises(ValueError, match="splits"):
            tatt.flash_decode_attention(*_k21(t), layer=0, splits=bad)
    with pytest.raises(ValueError, match="blocked"):
        tatt.flash_decode_attention(*_k21(t), layer=0, block_s=128, splits=2)
    blocked = tatt.flash_decode_attention(*_k21(t), layer=0, block_s=128, splits=1)
    assert torch.equal(blocked, tatt.flash_decode_attention(*_k21(t), layer=0, block_s=128))

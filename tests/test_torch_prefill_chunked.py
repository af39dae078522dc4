"""Port parity of prefill beyond position 0: K18's plain version
(``kv_cache_write_chunk``), ``forward_prefill`` at start_pos > 0 and
``forward_prefill_chunked``, against the JAX package on the CPU (its Pallas
kernels in interpret mode), on inputs made with numpy from a seed.

Limits, of max |logit|:

* K18: byte-equal (a copy).
* The JAX package's fused W8A8 body at start_pos > 0 needs
  ``attn="flash"``, and its chunked carry form always runs the Pallas
  stages; the port is given ``attn="flash"`` there too.  Both K6s round the
  pre-scaled queries and p * vs to bf16 before their dots, but JAX's walks
  its key blocks with an online softmax where the plain version takes one
  pass (test_torch_attention.py: 4e-3 of the peak output), and through the
  next matmuls' int8 quant the logits agree to FLASH_TOL = 5e-2.  XLA's
  FMA contraction inside the interpreted K3/K4/K5
  (test_torch_fused_quant.py) is far below that.
* The unfused body is also held to JAX's ``attn="xla"`` f32 attention
  (the port's ``attention_prefill``, what ``"auto"`` runs on the CPU):
  F32_TOL (f32 activations) and BF16_TOL (bf16), test_torch_model.py's
  limits for the fresh body.
* The port against itself, with one ``attn`` throughout: the chunked
  prefill equals per-chunk ``forward_prefill`` calls and the one-shot fresh
  prefill bit for bit in the cache, logits within 1e-5 of max |logit|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import BF16_TOL, F32_TOL, TINY128, TINY_GQA, _close, build_fused_pair, \
    build_pair
from tpu_llama.models import llama as jl
from tpu_llama.ops import attention as jatt
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

FLASH_TOL = 5e-2


# --------------------------------------------------------------------- K18


@pytest.mark.parametrize("stacked,start", [(True, 128), (True, 256), (False, 0),
                                           (False, 256)])
def test_k18_plain_equals_jax(stacked, start):
    rng = np.random.default_rng(start + stacked)
    L, B, KVH, Tc, hd, S, layer = 3, 2, 2, 128, 16, 384, 1
    lead = (L,) if stacked else ()
    rows = [rng.integers(-127, 128, (B, KVH, Tc, hd), dtype=np.int8) for _ in range(2)]
    rows_s = [rng.uniform(0, 1, (B, KVH, Tc)).astype(np.float32) for _ in range(2)]
    cache = [rng.integers(-127, 128, (*lead, B, KVH, S, hd), dtype=np.int8) for _ in range(2)]
    cache_s = [rng.uniform(0, 1, (*lead, B, KVH, S)).astype(np.float32) for _ in range(2)]
    want = jatt.kv_cache_write_chunk(
        *(jnp.asarray(a) for a in (*rows, *rows_s)), jnp.int32(start),
        jnp.int32(layer) if stacked else None, *(jnp.asarray(a) for a in (*cache, *cache_s)))
    ck, cv, cks, cvs = (torch.tensor(a) for a in (*cache, *cache_s))
    before = _kernels.PLAIN_CALLS["K18"]
    got = tatt.kv_cache_write_chunk(*(torch.tensor(a) for a in (*rows, *rows_s)), start,
                                    layer, ck, cv, cks, cvs)
    assert _kernels.PLAIN_CALLS["K18"] == before + 1
    for g, orig, w in zip(got, (ck, cv, cks, cvs), want):
        assert g is orig  # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k18_rejects_rows_outside_the_cache():
    L, B, KVH, Tc, hd, S = 2, 1, 2, 8, 16, 32
    rk = torch.zeros(B, KVH, Tc, hd, dtype=torch.int8)
    rs = torch.zeros(B, KVH, Tc)
    ck = torch.zeros(L, B, KVH, S, hd, dtype=torch.int8)
    cs = torch.zeros(L, B, KVH, S)
    tatt.kv_cache_write_chunk(rk, rk, rs, rs, S - Tc, 1, ck, ck.clone(), cs, cs.clone())
    for start, layer in ((S - Tc + 1, 0), (-1, 0), (0, L)):
        with pytest.raises(ValueError):
            tatt.kv_cache_write_chunk(rk, rk, rs, rs, start, layer, ck, ck.clone(), cs,
                                      cs.clone())
    with pytest.raises(ValueError):
        tatt.kv_cache_write_chunk(rk, rk, rs[:, :1], rs, 0, 0, ck, ck.clone(), cs, cs.clone())
    with pytest.raises(TypeError):
        tatt.kv_cache_write_chunk(rk.float(), rk, rs, rs, 0, 0, ck, ck.clone(), cs, cs.clone())


# ----------------------------------------------------- start_pos > 0


def _cache_pair(cfg, B, S, seed):
    """The same random INT8 cache (the prefix rows a restore left) for
    both packages."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    arrs = [rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2)]
    arrs += [rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32) for _ in range(2)]
    names = ("k", "v", "ks", "vs")
    return (jl.QuantKVCache(**{n: jnp.asarray(a) for n, a in zip(names, arrs)}),
            tl.QuantKVCache(**{n: torch.tensor(a) for n, a in zip(names, arrs)}))


STARTS = np.array([5, 40], np.int32)


def _continue_both(pair, mode, attn):
    jcfg, jp, tcfg, tp = pair
    B, T, S = 2, 16, 64
    rng = np.random.default_rng(1)
    toks = rng.integers(3, tcfg.vocab_size, (B, T)).astype(np.int32)
    lengths = np.array([16, 9], np.int32)
    jc, tc = _cache_pair(tcfg, B, S, seed=3)
    want, jc = jl.forward_prefill(jp, jc, jnp.asarray(toks), jnp.asarray(STARTS),
                                  jnp.asarray(lengths), jcfg, logits_mode=mode, attn=attn)
    got, tc2 = tl.forward_prefill(tp, tc, torch.tensor(toks), torch.tensor(STARTS),
                                  torch.tensor(lengths), tcfg, logits_mode=mode, attn=attn)
    assert tc2 is tc and got.shape == want.shape
    return got.numpy(), np.asarray(want, np.float32), jc, tc


CASES = [(jnp.float32, "all"), (jnp.float32, "last"), (jnp.bfloat16, "last")]
CASE_IDS = ["f32-all", "f32-last", "bf16-last"]


@pytest.mark.parametrize("dtype,mode", CASES, ids=CASE_IDS)
def test_prefill_at_start_fused_matches_jax(dtype, mode):
    """Fused layouts (TINY128, B * T = 32: JAX runs its fused body with
    ``attn="flash"``): per-row starts 5 and 40 in a cache of 64 rows."""
    pair = build_fused_pair(TINY128, dtype, seed=7)
    _kernels.reset_counts()
    got, want, jc, tc = _continue_both(pair, mode, "flash")
    L = TINY128["n_layers"]
    plain = _kernels.PLAIN_CALLS
    assert (plain["K3"], plain["K4"], plain["K5"], plain["K6"]) == (2 * L, L, L, L)
    assert plain["K1"] == 4 * L + 1 and plain["K18"] == plain["K7"] == 0
    _close(got, want, FLASH_TOL)
    # layer 0's rows at the new positions depend on no attention: equal K/V
    for b, s in enumerate(STARTS):
        rows = slice(int(s), int(s) + 16)
        assert (tc.k[0, b, :, rows].numpy() != np.asarray(jc.k)[0, b, :, rows]).mean() <= 1e-2


@pytest.mark.parametrize("dtype,mode", CASES, ids=CASE_IDS)
def test_prefill_at_start_unfused_matches_jax(dtype, mode):
    """Unfused layouts (TINY_GQA): against JAX's f32 attention (``"xla"``)
    at the fresh body's limits, and, with f32 activations, against its
    Pallas K6 (``"flash"``)."""
    pair = build_pair(TINY_GQA, dtype, seed=7)
    got, want, jc, tc = _continue_both(pair, mode, "xla")
    _close(got, want, F32_TOL if dtype == jnp.float32 else BF16_TOL)
    for b, s in enumerate(STARTS):  # the rows before the start are untouched
        np.testing.assert_array_equal(tc.k[:, b, :, :s].numpy(), np.asarray(jc.k)[:, b, :, :s])
    if dtype == jnp.float32:
        got, want, _, _ = _continue_both(pair, mode, "flash")
        _close(got, want, FLASH_TOL)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_prefill_at_start_zero_equals_fresh(fuse):
    """The port against itself: the start_pos route at start 0 into an empty
    cache gives the fresh route's logits and cache rows."""
    _, _, tcfg, tp = (build_fused_pair(TINY128, jnp.float32, seed=8) if fuse
                      else build_pair(TINY_GQA, jnp.float32, seed=8))
    B, T = 2, 16
    toks = torch.tensor(np.random.default_rng(4).integers(3, 320, (B, T)))
    lengths = torch.tensor([16, 11])
    fresh = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=T, device="cpu")
    want, _ = tl.forward_prefill(tp, fresh, toks, torch.zeros(B), lengths, tcfg,
                                 logits_mode="all", assume_fresh=True)
    cache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=64, device="cpu")
    got, _ = tl.forward_prefill(tp, cache, toks, torch.zeros(B), lengths, tcfg, logits_mode="all")
    _close(got.numpy(), want.numpy(), 1e-5)
    for n in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(cache, n)[:, :, :, :T], getattr(fresh, n))


# ------------------------------------------------------------- chunked


def _chunked_case(pair, B=2, T=256, chunk=128, attn="auto"):
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(2).integers(3, tcfg.vocab_size, (B, T)).astype(np.int32)
    lengths = np.array([256, 131], np.int32)
    tc = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=T, device="cpu")
    _kernels.reset_counts()
    got, tc = tl.forward_prefill_chunked(tp, tc, torch.tensor(toks), torch.tensor(lengths),
                                         tcfg, chunk=chunk, attn=attn)
    counts = dict(_kernels.PLAIN_CALLS)
    # the port's per-chunk forward_prefill calls and its one-shot fresh prefill
    per = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=T, device="cpu")
    logits = []
    for i in range(T // chunk):
        li, _ = tl.forward_prefill(
            tp, per, torch.tensor(toks[:, i * chunk:(i + 1) * chunk]),
            torch.full((B,), i * chunk), torch.tensor(np.clip(lengths - i * chunk, 1, chunk)),
            tcfg, logits_mode="last", attn=attn)
        logits.append(li)
    owner = torch.tensor(np.clip((lengths - 1) // chunk, 0, T // chunk - 1))
    _close(got.numpy(), torch.stack(logits)[owner, torch.arange(B)].numpy(), 1e-5)
    one = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=T, device="cpu")
    one_logits, _ = tl.forward_prefill(tp, one, torch.tensor(toks), torch.zeros(B),
                                       torch.tensor(lengths), tcfg, logits_mode="last",
                                       assume_fresh=True, attn=attn)
    _close(got.numpy(), one_logits.numpy(), 1e-5)
    for n in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(tc, n), getattr(per, n))
        assert torch.equal(getattr(tc, n), getattr(one, n))
    return toks, lengths, got.numpy(), tc, counts


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_chunked_fused_matches_jax_carry(dtype):
    """``forward_prefill_chunked`` on fused layouts against
    ``forward_prefill_chunked_carry`` on the contract of test_model.py's
    carry test: head_dim 128, B 2, T 256, chunk 128, lengths [256, 131]."""
    pair = build_fused_pair(dict(TINY128, seq_len=256), dtype, seed=9)
    jcfg, jp = pair[:2]
    toks, lengths, got, tc, counts = _chunked_case(pair, attn="flash")
    L, n = TINY128["n_layers"], 2
    assert counts["K18"] == counts["K5"] == counts["K6"] == counts["K4"] == n * L
    assert counts["K3"] == 2 * n * L and counts["K1"] == n * (4 * L + 1)
    assert counts["K2"] == n * (L + 1) and counts["K7"] == 0
    jc = jl.make_kv_cache(jcfg, 2, kv_dtype="int8", seq_len=256)
    assert jl._prefill_chunked_carry_ok(jp, jcfg, jc, 2, 128)
    want, jc = jl.forward_prefill_chunked_carry(jp, jc, jnp.asarray(toks), jnp.asarray(lengths),
                                                jcfg, chunk=128)
    _close(got, np.asarray(want), FLASH_TOL)
    # the first chunk's layer-0 rows depend on no attention
    assert (tc.k[0, :, :, :128].numpy() != np.asarray(jc.k)[0, :, :, :128]).mean() <= 1e-2


def test_chunked_unfused_matches_jax():
    """Unfused layouts: JAX's ``forward_prefill_chunked`` (its CPU default,
    f32 attention) at the fresh body's f32 limit."""
    pair = build_pair(dict(TINY_GQA, seq_len=256), jnp.float32, seed=10)
    jcfg, jp = pair[:2]
    toks, lengths, got, tc, counts = _chunked_case(pair)
    assert counts["K18"] == 0 and counts["K6"] == 0  # "auto": "xla" on the CPU, as in JAX
    jc = jl.make_kv_cache(jcfg, 2, kv_dtype="int8", seq_len=256)
    want, jc = jl.forward_prefill_chunked(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jcfg,
                                          chunk=128)
    _close(got, np.asarray(want), F32_TOL)


def test_chunked_rejects_ragged_prompts():
    _, _, tcfg, tp = build_pair(TINY_GQA, jnp.float32, seed=10)
    cache = tl.make_kv_cache(tcfg, 1, kv_dtype="int8", seq_len=64, device="cpu")
    with pytest.raises(ValueError):
        tl.forward_prefill_chunked(tp, cache, torch.ones(1, 48, dtype=torch.long),
                                   torch.tensor([48]), tcfg, chunk=32)
    with pytest.raises(ValueError):
        tl.forward_prefill_chunked(tp, cache, torch.ones(1, 128, dtype=torch.long),
                                   torch.tensor([128]), tcfg, chunk=32)

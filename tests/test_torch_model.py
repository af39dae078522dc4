"""Port parity at model level: ``forward_prefill(assume_fresh=True)``,
``forward_decode(attn="xla")`` and ``greedy_decode_loop`` against the JAX
package on a tiny W8A8 / INT8-KV GQA config, plus the numpy conversion.

Both packages get the same weights: the JAX package quantizes them and
``convert.params_from_numpy`` hands its arrays to the port.  Tolerances:

* f32 activations: logits within 1e-4 of max |logit|.  The int8 products
  are exact in both; what differs is f32 summation order in rmsnorm, RoPE,
  softmax and attention, which can at most flip a rare activation-quant
  rounding by one step.
* bf16 activations: logits within 3e-2 of max |logit|.  Every residual add
  and norm output rounds to bf16 (8 significant bits) in both packages, but
  XLA and PyTorch round at different places (XLA keeps some chains in f32),
  so a bf16 ulp of difference feeds the next layer's int8 quantization.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig as JaxModelConfig
from tpu_llama.io.checkpoint import make_random_weights
from tpu_llama.models import llama as jl
from tpu_llama_torch import convert
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels

torch.set_num_threads(1)

TINY_GQA = dict(dim=48, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=320, seq_len=64, shared_weights=False)
F32_TOL, BF16_TOL = 1e-4, 3e-2


def jax_tree(obj):
    """A JAX params dataclass -> the nested numpy dict convert takes."""
    if dataclasses.is_dataclass(obj):
        out = {f.name: jax_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        return {k: v for k, v in out.items() if k != "packed4"}
    return obj if isinstance(obj, int) else np.asarray(obj)


def build_pair(cfg_kwargs, dtype, seed=3):
    """(jax config, jax params, port config, port params on the CPU)."""
    jcfg = JaxModelConfig(**cfg_kwargs)
    raw = make_random_weights(jcfg, seed=seed)
    jp = jl.quantize_params(jl.params_from_raw(raw, dtype=dtype), mode="w8a8")
    tp = convert.params_from_numpy(jax_tree(jp), device="cpu")
    return jcfg, jp, ModelConfig(**cfg_kwargs), tp


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module", params=[jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def pair(request):
    return build_pair(TINY_GQA, request.param) + (request.param,)


def _prompts(B, T, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, vocab, (B, T)).astype(np.int32)
    lengths = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lengths[0] = T
    return toks, lengths


@pytest.mark.parametrize("mode", ["all", "last"])
def test_prefill_fresh_matches_jax(pair, mode):
    jcfg, jp, tcfg, tp, dtype = pair
    B, T = 3, 16
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 1)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=T)
    want, jcache = jl.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.zeros((B,), jnp.int32), jnp.asarray(lengths),
        jcfg, logits_mode=mode, assume_fresh=True)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=T, device="cpu")
    got, tcache2 = tl.forward_prefill(
        tp, tcache, torch.tensor(toks), torch.zeros(B, dtype=torch.int32),
        torch.tensor(lengths), tcfg, logits_mode=mode, assume_fresh=True)
    assert tcache2 is tcache
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    _close(got.numpy(), want, tol)
    # the cache block: dequantized K/V agree to the activation tolerance
    for qn, sn in (("k", "ks"), ("v", "vs")):
        jf = np.asarray(getattr(jcache, qn), np.float32) * np.asarray(getattr(jcache, sn))[..., None]
        tf = getattr(tcache, qn).float() * getattr(tcache, sn)[..., None]
        _close(tf.numpy(), jf, tol * 4)


def test_decode_matches_jax(pair):
    jcfg, jp, tcfg, tp, dtype = pair
    B, T, S = 3, 8, 32
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 2)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    jlog, jcache = jl.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.zeros((B,), jnp.int32), jnp.asarray(lengths),
        jcfg, logits_mode="last", assume_fresh=True)
    tl.forward_prefill(tp, tcache, torch.tensor(toks), torch.zeros(B, dtype=torch.int32),
                       torch.tensor(lengths), tcfg, logits_mode="last", assume_fresh=True)
    nxt = np.asarray(jnp.argmax(jlog, -1), np.int32)
    pos = lengths.copy()
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    for _ in range(3):
        want, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                                         jcfg, attn="xla", fused=False)
        got, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                   attn="xla")
        _close(got.numpy(), want, tol)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)  # teacher-force JAX's tokens
        pos = pos + 1


def test_greedy_decode_loop_matches_jax():
    jcfg, jp, tcfg, tp = build_pair(TINY_GQA, jnp.float32, seed=5)
    B, S, steps = 2, 32, 6
    toks = np.array([5, 77], np.int32)
    pos = np.array([0, 3], np.int32)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    want, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(toks), jnp.asarray(pos), steps,
                                    jcfg, attn="xla", fused=False)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    got, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(toks), torch.tensor(pos), steps,
                                   tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dequant(cache):
    return [np.asarray(getattr(cache, qn), np.float32)
            * np.asarray(getattr(cache, sn))[..., None] for qn, sn in (("k", "ks"), ("v", "vs"))]


@pytest.mark.parametrize("attn", ["flash", "flash_dma"])
def test_decode_flash_matches_jax(pair, attn):
    """The deferred-flush decode (K19 / K9 + the K10 flush) against the JAX
    package's same ``attn``: both round q and p to bf16 at the same places,
    so F32_TOL and BF16_TOL hold as for xla.  After three steps the
    dequantized caches agree to the prefill test's limit."""
    jcfg, jp, tcfg, tp, dtype = pair
    B, T, S = 3, 8, 32
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 2)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    jlog, jcache = jl.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.zeros((B,), jnp.int32), jnp.asarray(lengths),
        jcfg, logits_mode="last", assume_fresh=True)
    tl.forward_prefill(tp, tcache, torch.tensor(toks), torch.zeros(B, dtype=torch.int32),
                       torch.tensor(lengths), tcfg, logits_mode="last", assume_fresh=True)
    nxt = np.asarray(jnp.argmax(jlog, -1), np.int32)
    pos = lengths.copy()
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    _kernels.reset_counts()
    for _ in range(3):
        want, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                                         jcfg, attn=attn, fused=False)
        got, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                   attn=attn)
        _close(got.numpy(), want, tol)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)  # teacher-force JAX's tokens
        pos = pos + 1
    kernel = "K9" if attn == "flash_dma" else "K19"
    assert _kernels.PLAIN_CALLS[kernel] == 3 * tcfg.n_layers and _kernels.PLAIN_CALLS["K10"] == 3
    for tf, jf in zip(_dequant(tcache), _dequant(jcache)):
        _close(tf, jf, tol * 4)


@pytest.mark.parametrize("attn", ["flash", "flash_dma"])
def test_greedy_decode_loop_flash_matches_jax(attn):
    jcfg, jp, tcfg, tp = build_pair(TINY_GQA, jnp.float32, seed=5)
    B, S, steps = 2, 32, 6
    toks = np.array([5, 77], np.int32)
    pos = np.array([0, 3], np.int32)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    want, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(toks), jnp.asarray(pos), steps,
                                    jcfg, attn=attn, fused=False)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    got, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(toks), torch.tensor(pos), steps,
                                   tcfg, attn=attn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_decode_attn():
    cfg = ModelConfig(**TINY_GQA)
    cache = tl.make_kv_cache(cfg, 2, kv_dtype="int8", seq_len=16, device="cpu")
    assert tl._resolve_decode_attn("auto", cache) == "xla"  # the JAX package on the CPU
    for attn in ("flash", "flash_dma", "xla"):
        assert tl._resolve_decode_attn(attn, cache) == attn
    with pytest.raises(ValueError):
        tl._resolve_decode_attn("pallas", cache)


def test_model_runs_on_plain_versions_only():
    _, _, tcfg, tp = build_pair(TINY_GQA, jnp.float32)
    _kernels.reset_counts()
    cache = tl.make_kv_cache(tcfg, 1, kv_dtype="int8", seq_len=16, device="cpu")
    tl.forward_prefill(tp, cache, torch.tensor([[1, 9, 4]]), torch.zeros(1),
                       torch.tensor([3]), tcfg, assume_fresh=True, attn="flash")
    assert all(v == 0 for v in _kernels.LAUNCHES.values())
    assert _kernels.PLAIN_CALLS["K1"] > 0 and _kernels.PLAIN_CALLS["K6"] == 2


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "at-start"])
def test_resolve_prefill_attn(fresh):
    """The prefill's ``attn`` resolves as JAX's (llama.py:1396-1397,
    :2079-2083): "auto" is "xla" on a CPU cache, attention_prefill's f32
    math, bit for bit; an explicit "flash" runs K6's plain version (the
    card's function) there; anything else raises."""
    cfg = ModelConfig(**TINY_GQA)
    cache = tl.make_kv_cache(cfg, 2, kv_dtype="int8", seq_len=16, device="cpu")
    assert tl._resolve_prefill_attn("auto", cache) == "xla"
    for attn in ("flash", "xla"):
        assert tl._resolve_prefill_attn(attn, cache) == attn
    with pytest.raises(ValueError):
        tl._resolve_prefill_attn("flash_dma", cache)
    _, _, tcfg, tp = build_pair(TINY_GQA, jnp.float32)
    toks, lengths = torch.tensor([[1, 9, 4, 7], [5, 2, 8, 3]]), torch.tensor([4, 3])
    out, k6 = {}, {}
    for attn in ("auto", "xla", "flash"):
        _kernels.reset_counts()
        c = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", seq_len=16, device="cpu")
        out[attn], _ = tl.forward_prefill(tp, c, toks, torch.zeros(2), lengths, tcfg,
                                          assume_fresh=fresh, attn=attn)
        k6[attn] = _kernels.PLAIN_CALLS["K6"]
    assert torch.equal(out["auto"], out["xla"]) and k6["auto"] == k6["xla"] == 0
    assert k6["flash"] == tcfg.n_layers and not torch.equal(out["flash"], out["xla"])
    with pytest.raises(ValueError):
        tl.forward_prefill(tp, c, toks, torch.zeros(2), lengths, tcfg, attn="pallas")


def test_convert_round_trip():
    """JAX params (padded to its TPU tiles) -> port -> numpy: the logical
    weights come back unpadded and unchanged."""
    _, jp, tcfg, tp = build_pair(TINY_GQA, jnp.bfloat16)
    tree = jax_tree(jp)
    back = convert.params_to_numpy(tp)
    wq = tree["layers"]["wq"]
    assert wq["q"].shape[-1] == 128 and tp.layers.wq.q.shape == (2, 48, 48)
    assert tp.tok_emb.dtype == torch.bfloat16 and tp.layers.wq.q.dtype == torch.int8
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        w, b = tree["layers"][name], back["layers"][name]
        n_in, n_out = w["logical_in"], w["logical_out"]
        np.testing.assert_array_equal(b["q"], w["q"][..., :n_in, :n_out])
        np.testing.assert_array_equal(b["s"], w["s"][..., :n_out])
        assert (b["logical_in"], b["logical_out"]) == (n_in, n_out)
    for name in ("tok_emb", "rms_final", "rope_cos", "rope_sin"):
        np.testing.assert_array_equal(back[name], np.asarray(tree[name], np.float32))
    again = convert.params_from_numpy(back, device="cpu")
    assert torch.equal(again.wcls.q, tp.wcls.q) and torch.equal(again.wcls.s, tp.wcls.s)


def test_quantize_params_matches_jax():
    cfg = JaxModelConfig(**TINY_GQA)
    raw = make_random_weights(cfg, seed=8)
    dense = jl.params_from_raw(raw)
    jq = jl.quantize_params(dense, mode="w8a8")
    tq = tl.quantize_params(convert.params_from_numpy(jax_tree(dense), device="cpu"),
                            mode="w8a8")
    for name in ("wq", "w2"):
        w = getattr(jq.layers, name)
        np.testing.assert_array_equal(
            getattr(tq.layers, name).q.numpy(),
            np.swapaxes(np.asarray(w.q)[..., :w.logical_in, :w.logical_out], -1, -2))


def test_random_quant_params_shapes_and_seed():
    cfg = ModelConfig(**TINY_GQA)
    a = tl.random_quant_params(cfg, seed=4, device="cpu")
    b = tl.random_quant_params(cfg, seed=4, device="cpu")
    assert a.layers.w1.q.shape == (2, 128, 48) and a.layers.w2.q.shape == (2, 48, 128)
    assert a.wcls.q.shape == (320, 48) and a.tok_emb.dtype == torch.bfloat16
    assert torch.equal(a.layers.wq.q, b.layers.wq.q)
    assert int(a.layers.wq.q.min()) >= -127
    f = tl.random_quant_params(cfg, fuse=True, device="cpu")  # the fused layouts
    KVD = cfg.kv_dim
    assert f.layers.wq.q.shape == (2, 48 + 2 * KVD, 48) and f.layers.w1.q.shape == (2, 256, 48)
    assert f.layers.wo.q.shape == (2, 48, 48) and f.layers.w2.q.shape == (2, 48, 128)
    for stub in (f.layers.wk, f.layers.wv, f.layers.w3):
        assert isinstance(stub, torch.Tensor) and stub.shape == (2, 1, 1)
    assert tl._fused_layouts(f.layers, cfg) and not tl._fused_layouts(a.layers, cfg)
    with pytest.raises(ValueError):  # paged caches are INT8 only, as in JAX
        tl.make_kv_cache(cfg, 2, kv_dtype="bfloat16", paged=True, device="cpu")
    assert isinstance(tl.make_kv_cache(cfg, 2, kv_dtype="int8", paged=True, page_size=16,
                                       device="cpu"), tl.PagedKVCache)
    # start_pos > 0 is ported: the logits of every position, the rows written
    cache = tl.make_kv_cache(cfg, 1, kv_dtype="int8", device="cpu")
    logits, _ = tl.forward_prefill(a, cache, torch.ones(1, 4, dtype=torch.long), torch.ones(1),
                                   torch.tensor([4]), cfg)
    assert logits.shape == (1, 4, cfg.vocab_size)
    assert (cache.ks[:, 0, :, 1:5] > 0).all() and not cache.ks[:, 0, :, 0].any()


# ---------------------------------------------------------------------------
# Fused layouts (fuse_projections: wqkv, w13) and the fused W8A8 prefill body.
# TINY128 has head_dim 128 and GQA, so with B * T a multiple of 32 the JAX
# package runs its fused body too (_prefill_w8a8_fast_ok).  With attn="xla":
# K3, K4 and the residual K1, then RoPE + quantize_kv + f32 attention; the
# port runs K3, K4, the residual K1, K5 and attention_prefill (that same f32
# attention).  f32: K5's RoPE and quant are apply_rope + quantize_kv's
# arithmetic, so F32_TOL holds.  bf16: K5 quantizes the roped k before any
# bf16 rounding where JAX's xla branch rounds it first, within BF16_TOL.
# With attn="flash" both run K5 and K6 (JAX's single-block fresh kernel in
# interpret mode, the port's plain version: the same bf16 roundings in one
# pass, 16 keys being one block and one tile), at the same limits.
# ---------------------------------------------------------------------------

TINY128 = dict(dim=256, hidden_dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
               vocab_size=320, seq_len=64, shared_weights=False)


def build_fused_pair(cfg_kwargs, dtype, seed=3):
    """build_pair with the JAX package's fused layouts, quantized."""
    jcfg = JaxModelConfig(**cfg_kwargs)
    dense = jl.params_from_raw(make_random_weights(jcfg, seed=seed), dtype=dtype)
    jp = jl.quantize_params(jl.fuse_projections(dense), mode="w8a8")
    tp = convert.params_from_numpy(jax_tree(jp), device="cpu")
    return jcfg, jp, ModelConfig(**cfg_kwargs), tp


@pytest.fixture(scope="module", params=[jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def fused_pair(request):
    return build_fused_pair(TINY128, request.param) + (request.param,)


def _count_residual_k1(monkeypatch):
    """Counts plain K1 calls that carry a residual."""
    from tpu_llama_torch.ops import matmul as tm

    calls = []
    plain = tm.w8a8_matmul_prequant_plain

    def counted(*args, **kwargs):
        calls.append(args[4] if len(args) > 4 else kwargs.get("residual"))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tm, "w8a8_matmul_prequant_plain", counted)
    return calls


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("mode", ["all", "last"])
def test_fused_prefill_matches_jax(fused_pair, mode, attn, monkeypatch):
    jcfg, jp, tcfg, tp, dtype = fused_pair
    B, T = 2, 16
    assert jl._prefill_w8a8_fast_ok(jp, jcfg, B, T)  # JAX runs its fused body too
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 4)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=T)
    want, jcache = jl.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.zeros((B,), jnp.int32), jnp.asarray(lengths),
        jcfg, logits_mode=mode, attn=attn, assume_fresh=True)
    calls = _count_residual_k1(monkeypatch)
    _kernels.reset_counts()
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=T, device="cpu")
    got, _ = tl.forward_prefill(
        tp, tcache, torch.tensor(toks), torch.zeros(B, dtype=torch.int32),
        torch.tensor(lengths), tcfg, logits_mode=mode, assume_fresh=True, attn=attn)
    L = tcfg.n_layers
    plain = _kernels.PLAIN_CALLS
    k6 = L if attn == "flash" else 0
    assert (plain["K3"], plain["K4"], plain["K5"], plain["K6"]) == (2 * L, L, L, k6)
    assert plain["K1"] == 4 * L + 1 and plain["K2"] == L + 1  # + the classifier
    assert sum(r is not None for r in calls) == 2 * L  # wo and w2 take the residual
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    _close(got.numpy(), want, tol)
    for tf, jf in zip(_dequant(tcache), _dequant(jcache)):
        _close(tf, jf, tol * 4)


@pytest.mark.parametrize("attn", ["xla", "flash_dma"])
def test_fused_decode_matches_jax(fused_pair, attn):
    """Prefill (fused on both sides: B * T = 32) into a larger cache, then
    JAX's unfused decode math on the fused layouts (fused=False), which the
    port keeps: the split q/k/v and gate/up, the residual adds in K1."""
    jcfg, jp, tcfg, tp, dtype = fused_pair
    B, T, S = 4, 8, 32
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 5)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    jlog, jcache = jl.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.zeros((B,), jnp.int32), jnp.asarray(lengths),
        jcfg, logits_mode="last", attn="xla", assume_fresh=True)
    tl.forward_prefill(tp, tcache, torch.tensor(toks), torch.zeros(B, dtype=torch.int32),
                       torch.tensor(lengths), tcfg, logits_mode="last", assume_fresh=True)
    assert not tcache.ks[:, :, :, T:].any()  # K5 wrote rows [0, T) only
    nxt = np.asarray(jnp.argmax(jlog, -1), np.int32)
    pos = lengths.copy()
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    for _ in range(3):
        want, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos),
                                         jcfg, attn=attn, fused=False)
        got, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                   attn=attn)
        _close(got.numpy(), want, tol)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)  # teacher-force JAX's tokens
        pos = pos + 1
    for tf, jf in zip(_dequant(tcache), _dequant(jcache)):
        _close(tf, jf, tol * 4)


@pytest.mark.parametrize("attn", ["xla", "flash_dma"])
def test_fused_greedy_decode_loop_matches_jax(attn):
    jcfg, jp, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    B, S, steps = 2, 32, 6
    toks = np.array([5, 77], np.int32)
    pos = np.array([0, 3], np.int32)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    want, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(toks), jnp.asarray(pos), steps,
                                    jcfg, attn=attn, fused=False)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    got, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(toks), torch.tensor(pos), steps,
                                   tcfg, attn=attn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_fuse_projections_and_quantize_match_jax(dtype):
    """The port's fuse_projections + quantize_params on the same dense
    weights give the JAX package's bytes; the [L, 1, 1] stubs stay dense;
    fuse_projections(tp=2) gives JAX's shard-interleaved order."""
    cfg = JaxModelConfig(**TINY_GQA)
    dense = jl.params_from_raw(make_random_weights(cfg, seed=9), dtype=dtype)
    jq = jl.quantize_params(jl.fuse_projections(dense), mode="w8a8")
    tdense = convert.params_from_numpy(jax_tree(dense), device="cpu")
    fused = tl.fuse_projections(tdense)
    tq = tl.quantize_params(fused, mode="w8a8")
    KVD, H = cfg.kv_dim, cfg.hidden_dim
    assert fused.layers.wq.shape == (2, 48, 48 + 2 * KVD)
    assert fused.layers.w1.shape == (2, 48, 2 * H)
    for name in ("wq", "wo", "w1", "w2"):
        w, t = getattr(jq.layers, name), getattr(tq.layers, name)
        np.testing.assert_array_equal(
            t.q.numpy(), np.swapaxes(np.asarray(w.q)[..., :w.logical_in, :w.logical_out], -1, -2))
        np.testing.assert_array_equal(t.s.numpy(), np.asarray(w.s)[..., :w.logical_out])
    for name in ("wk", "wv", "w3"):
        stub = getattr(tq.layers, name)
        assert isinstance(stub, torch.Tensor) and stub.shape == (2, 1, 1)
        assert np.asarray(getattr(jq.layers, name)).shape == (2, 1, 1)
    assert tl._fused_layouts(tq.layers, ModelConfig(**TINY_GQA))
    with pytest.raises(ValueError):
        tl.fuse_projections(tq)
    # tp=2: the shard-interleaved [q_i | k_i | v_i] and [w1_i | w3_i] column
    # order of the explicit tensor-parallel path, byte-equal to JAX's
    jt = jl.fuse_projections(dense, tp=2)
    tt = tl.fuse_projections(tdense, tp=2)
    for name in ("wq", "w1"):
        np.testing.assert_array_equal(getattr(tt.layers, name).float().numpy(),
                                      np.asarray(getattr(jt.layers, name), np.float32))
    assert not torch.equal(tt.layers.wq, fused.layers.wq)


def test_convert_round_trip_fused():
    """Fused, quantized JAX params -> port -> numpy -> port: the fused
    weights come back unchanged and the stubs stay dense."""
    _, jp, tcfg, tp = build_fused_pair(TINY128, jnp.bfloat16)
    back = convert.params_to_numpy(tp)
    assert back["layers"]["wk"].shape == (2, 1, 1)
    again = convert.params_from_numpy(back, device="cpu")
    for name in ("wq", "w1"):
        a, b = getattr(again.layers, name), getattr(tp.layers, name)
        assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)
    assert again.layers.w3.shape == (2, 1, 1) and tl._fused_layouts(again.layers, tcfg)
    w = jax_tree(jp)["layers"]["wq"]
    np.testing.assert_array_equal(back["layers"]["wq"]["q"],
                                  np.asarray(w["q"])[..., :w["logical_in"], :w["logical_out"]])

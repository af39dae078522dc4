"""The port's server model path on the CPU against the JAX package: dense f32
weights from a llama2.c checkpoint (``params_from_raw``) and the same
weights in Q8_0 (``quantize_params``' default), over float32 and bfloat16
KV caches -- prefill from 0, prefill at start > 0, chunked prefill and
decode (xla, flash, flash_dma); W8A8 fused layouts over an fp cache with
the two-launch fused decode; the golden greedy stream through ``Engine`` +
``ContinuousBatcher``; the defaults that follow JAX's; and the padding rows
of a continuation that ends at the cache's last row.

Limits (of max |logit|), and why:

* float32 cache: 1e-5.  Both sides compute in f32 with the same steps
  (dense products at "highest", which XLA on the CPU always is; Q8_0's bf16
  weights and bf16 x with exact products); only the order of f32 sums
  differs.
* bfloat16 cache: 1e-3.  K and V are rounded to bf16 on both sides from f32
  values a few ulps apart, which can flip one rounding by one bf16 step
  (2^-8 of that element); its share of a logit is far below that.
* Q8_0 weights: 1e-2.  K25 rounds every activation it multiplies to bf16
  (matmul.py:133), so f32 values a few ulps apart upstream (rmsnorm,
  attention sums) can land on either side of a bf16 rounding: that input
  moves by 2^-8 of itself, its products with it too; readings are below
  5e-3 of max |logit|.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig as JaxModelConfig
from tpu_llama.io.checkpoint import make_random_weights
from tpu_llama.models import llama as jl
from tpu_llama.ops import quant as jq
from tpu_llama_torch import convert
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import quant as tq
from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request

from test_torch_model import TINY128, build_fused_pair

torch.set_num_threads(1)

TINY_GQA = dict(dim=48, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=320, seq_len=64, shared_weights=False)
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GOLDEN = Path(__file__).parent / "golden" / "tiny_golden.json"


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def build(weights: str, cfg=TINY_GQA, seed=3):
    """(jax config, jax params, port config, port params on the CPU): the
    same checkpoint through each package's ``params_from_raw`` (f32), then
    for "q8_0" each package's default ``quantize_params``."""
    jcfg = JaxModelConfig(**cfg)
    raw = make_random_weights(jcfg, seed=seed)
    jp = jl.params_from_raw(raw)
    tp = tl.params_from_raw(convert.raw_weights_from(raw), device="cpu")
    if weights == "q8_0":
        jp, tp = jl.quantize_params(jp), tl.quantize_params(tp)
        assert isinstance(jp.layers.wq, jq.QuantTensor)
        assert isinstance(tp.layers.wq, tq.QuantTensor)
    return jcfg, jp, ModelConfig(**cfg), tp


@pytest.fixture(scope="module", params=["dense", "q8_0"])
def model(request):
    return build(request.param)


def _tol(model, kv: str) -> float:
    return 1e-2 if isinstance(model[3].layers.wq, tq.QuantTensor) else TOL[kv]


def _caches(jcfg, tcfg, B, S, kv, seed=None):
    """An fp cache on each side, zero or (with a seed) the same random rows."""
    jc = jl.make_kv_cache(jcfg, B, kv_dtype=kv, seq_len=S)
    tc = tl.make_kv_cache(tcfg, B, kv_dtype=kv, seq_len=S, device="cpu")
    if seed is not None:
        rng = np.random.default_rng(seed)
        arrs = {n: jnp.asarray(rng.standard_normal(jc.k.shape) * 0.5).astype(jc.k.dtype)
                for n in ("k", "v")}
        jc = jl.KVCache(**arrs)
        tc = convert.cache_from_numpy({n: np.asarray(a.astype(jnp.float32)) for n, a in
                                       arrs.items()}, device="cpu")
        tc = tl.KVCache(k=tc.k.to(tl.kv_torch_dtype(kv)), v=tc.v.to(tl.kv_torch_dtype(kv)))
        back = convert.cache_to_numpy(tc)
        assert sorted(back) == ["k", "v"]
        for n, a in arrs.items():
            np.testing.assert_array_equal(back[n], np.asarray(a.astype(jnp.float32)))
    return jc, tc


def _prompts(B, T, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, vocab, (B, T)).astype(np.int32)
    lengths = np.array([T] + list(rng.integers(T // 2, T, B - 1)), np.int32)
    return toks, lengths


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(model, kv):
    """Prefill from 0 (all positions' logits), then two teacher-forced
    decode steps in each decode attention, then three greedy steps."""
    jcfg, jp, tcfg, tp = model
    tol = _tol(model, kv)
    B, T, S = 3, 16, 64
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 1)
    jc, tc = _caches(jcfg, tcfg, B, S, kv)
    want, jc = jl.forward_prefill(jp, jc, jnp.asarray(toks), jnp.zeros(B, jnp.int32),
                                  jnp.asarray(lengths), jcfg, assume_fresh=True)
    got, tc = tl.forward_prefill(tp, tc, torch.tensor(toks), torch.zeros(B),
                                 torch.tensor(lengths), tcfg, assume_fresh=True)
    _close(got.numpy(), want, tol)
    assert tc.k.dtype == tl.kv_torch_dtype(kv)
    first = np.asarray(jnp.argmax(want[np.arange(B), lengths - 1], -1), np.int32)
    for attn in ("xla", "flash", "flash_dma"):
        jcache, tcache = jc, tl.KVCache(k=tc.k.clone(), v=tc.v.clone())
        nxt, pos = first, lengths.copy()
        for _ in range(2):
            jw, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), jcfg,
                                           attn=attn, fused=False)
            tw, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                      attn=attn, fused=False)
            _close(tw.numpy(), jw, tol)
            nxt, pos = np.asarray(jnp.argmax(jw, -1), np.int32), pos + 1
        jt, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), 3, jcfg,
                                      attn=attn, fused=False)
        tt, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(nxt), torch.tensor(pos), 3, tcfg,
                                      attn=attn, fused=False)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_prefill_at_start_and_chunked_match_jax(model, kv):
    """start_pos > 0 over a cache holding other rows, then chunked prefill
    (llama.py:1562: forward_prefill per chunk on an fp cache)."""
    jcfg, jp, tcfg, tp = model
    tol = _tol(model, kv)
    B, T, S = 2, 16, 64
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 2)
    starts = np.array([5, 40], np.int32)
    jc, tc = _caches(jcfg, tcfg, B, S, kv, seed=3)
    want, jc = jl.forward_prefill(jp, jc, jnp.asarray(toks), jnp.asarray(starts),
                                  jnp.asarray(lengths), jcfg, logits_mode="last")
    got, tc = tl.forward_prefill(tp, tc, torch.tensor(toks), torch.tensor(starts),
                                 torch.tensor(lengths), tcfg, logits_mode="last")
    _close(got.numpy(), want, tol)
    for b, (s, n) in enumerate(zip(starts, lengths)):  # rows before and at the new positions
        np.testing.assert_array_equal(tc.k[:, b, :, :s].float().numpy(),
                                      np.asarray(jc.k[:, b, :, :s].astype(jnp.float32)))
        _close(tc.v[:, b, :, s:s + n].float().numpy(),
               np.asarray(jc.v[:, b, :, s:s + n].astype(jnp.float32)), tol)
    T2, chunk = 64, 32
    toks, lengths = _prompts(B, T2, tcfg.vocab_size, 4)
    jc, tc = _caches(jcfg, tcfg, B, T2, kv)
    _kernels.reset_counts()
    want, jc = jl.forward_prefill_chunked(jp, jc, jnp.asarray(toks), jnp.asarray(lengths), jcfg,
                                          chunk=chunk)
    got, tc = tl.forward_prefill_chunked(tp, tc, torch.tensor(toks), torch.tensor(lengths),
                                         tcfg, chunk=chunk)
    _close(got.numpy(), want, tol)
    form = _kernels.form("K6", tl.kv_torch_dtype(kv))
    assert _kernels.PLAIN_CALLS[form] == 0 and _kernels.PLAIN_CALLS["K18"] == 0  # "xla"
    # "flash" on the CPU: K6's fp plain version, which computes the "xla" math
    _, tc = _caches(jcfg, tcfg, B, T2, kv)
    got, tc = tl.forward_prefill_chunked(tp, tc, torch.tensor(toks), torch.tensor(lengths),
                                         tcfg, chunk=chunk, attn="flash")
    _close(got.numpy(), want, tol)
    assert _kernels.PLAIN_CALLS[form] == 2 * tcfg.n_layers and _kernels.PLAIN_CALLS["K18"] == 0


@pytest.mark.parametrize("kv", ["float32", "bfloat16"])
def test_w8a8_fused_layouts_over_fp_cache(kv):
    """W8A8 fused layouts over an fp cache: the fused prefill body with the
    fp attention (no K5), then the two-launch fused decode's fp branch
    (K11 + K9's fp form, one fp K10 flush) against JAX's ``fused=True``;
    mega2 (K12) refuses an fp cache and ``"auto"`` never picks it."""
    jcfg, jp, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    B, T, S = 4, 8, 32
    toks, lengths = _prompts(B, T, tcfg.vocab_size, 6)
    jc, tc = _caches(jcfg, tcfg, B, S, kv)
    _kernels.reset_counts()
    want, jc = jl.forward_prefill(jp, jc, jnp.asarray(toks), jnp.zeros(B, jnp.int32),
                                  jnp.asarray(lengths), jcfg, logits_mode="last",
                                  assume_fresh=True)
    L = tcfg.n_layers
    plain = _kernels.PLAIN_CALLS
    form = _kernels.form("K6", tl.kv_torch_dtype(kv))
    for attn, k6 in (("auto", 0), ("flash", L)):  # "auto" is "xla" on the CPU, as in JAX
        _, tc = _caches(jcfg, tcfg, B, S, kv)
        _kernels.reset_counts()
        got, _ = tl.forward_prefill(tp, tc, torch.tensor(toks), torch.zeros(B),
                                    torch.tensor(lengths), tcfg, logits_mode="last",
                                    assume_fresh=True, attn=attn)
        assert plain["K5"] == 0 and plain["K3"] == 2 * L and plain["K4"] == L
        assert plain[form] == k6
        _close(got.numpy(), want, 1e-4 if kv == "float32" else TOL[kv])
    nxt, pos = np.asarray(jnp.argmax(want, -1), np.int32), lengths.copy()
    _kernels.reset_counts()
    for _ in range(2):
        jw, jc = jl.forward_decode(jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jcfg,
                                   attn="flash_dma", fused=True)
        tw, _ = tl.forward_decode(tp, tc, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                  attn="flash_dma", fused=True)
        _close(tw.numpy(), jw, 1e-4 if kv == "float32" else TOL[kv])
        nxt, pos = np.asarray(jnp.argmax(jw, -1), np.int32), pos + 1
    dt = tl.kv_torch_dtype(kv)
    assert plain["K11"] == 2 * L and plain[_kernels.form("K9", dt)] == 2 * L
    assert plain[_kernels.form("K10", dt)] == 2 and plain["K12"] == 0
    with pytest.raises(ValueError):
        tl._resolve_fused("mega2", "flash_dma", tp, tcfg, tc, B)
    assert not tl._mega2_path_ok(tp, tcfg, tc, B)
    dense = build("dense")[3]
    assert not tl._fused_path_ok(dense, ModelConfig(**TINY_GQA))
    assert not tl._fused_path_ok(tl.quantize_params(dense), ModelConfig(**TINY_GQA))


def test_engine_reproduces_golden_greedy(tiny_weights, tiny_tokenizer):
    """The port's Engine + ContinuousBatcher on ``params_from_raw`` of the
    golden checkpoint, default (float32) cache, "highest" precision, as
    tests/test_golden.py runs the JAX engine: token for token."""
    golden = json.loads(GOLDEN.read_text())["greedy_seed1"]
    cfg = golden["config"]
    raw = convert.raw_weights_from(tiny_weights)
    engine = Engine(tl.params_from_raw(raw, device="cpu"), raw.config, max_batch=1,
                    precision="highest", device="cpu")
    assert isinstance(engine.cache, tl.KVCache) and engine.cache.k.dtype == torch.float32
    b = ContinuousBatcher(engine)
    ptoks = tiny_tokenizer.encode(cfg["prompt"])
    r = Request(prompt_tokens=ptoks, steps=cfg["steps"], temperature=cfg["temperature"],
                seed=cfg["seed"])
    b.submit(r)
    b.run()
    assert ptoks + r.out_tokens == golden["tokens"]


def test_defaults_follow_jax():
    """make_kv_cache, Engine and quantize_params default to what the JAX
    functions default to, built side by side."""
    from tpu_llama.runtime import Engine as JaxEngine

    jcfg, jp, tcfg, tp = build("dense")
    jc, tc = jl.make_kv_cache(jcfg, 2), tl.make_kv_cache(tcfg, 2, device="cpu")
    assert type(jc).__name__ == type(tc).__name__ == "KVCache"
    assert str(jc.k.dtype) == str(tc.k.dtype).removeprefix("torch.") == "float32"
    je, te = JaxEngine(jp, jcfg, max_batch=2), Engine(tp, tcfg, max_batch=2, device="cpu")
    assert str(je.cache.k.dtype) == str(te.cache.k.dtype).removeprefix("torch.")
    assert je.precision == te.precision == "default"
    jqp, tqp = jl.quantize_params(jp), tl.quantize_params(tp)
    assert type(jqp.layers.w1).__name__ == type(tqp.layers.w1).__name__ == "QuantTensor"
    assert type(jqp.wcls).__name__ == type(tqp.wcls).__name__ == "QuantTensor"
    assert jqp.layers.w1.group_size == tqp.layers.w1.group_size
    with pytest.raises(ValueError):
        Engine(tp, tcfg, precision="fastest", device="cpu")


@pytest.mark.parametrize("kv", ["int8", "float32", "bfloat16"])
def test_continuation_ending_at_the_last_row_equals_cold_prefill(kv):
    """A prefix of 40 rows restored into slot 1, then a 24-token suffix in a
    32-row bucket: its real rows end at S - 1 = 63 and its padding rows lie
    past the cache.  The continued slot's logits and its cache rows [0, 64)
    equal a cold 64-token prefill's (the JAX package clips the padding rows
    to row 63 and can overwrite the prompt's last key there)."""
    if kv == "int8":
        cfg = ModelConfig(**TINY_GQA)
        params = tl.random_quant_params(cfg, seed=2, norm_dtype=torch.float32, device="cpu")
    else:
        _, _, cfg, params = build("dense")
    S = 64
    seq = [int(t) for t in np.random.default_rng(8).integers(3, 320, S)]
    eng = Engine(params, cfg, max_batch=2, kv_dtype=kv, seq_len=S, device="cpu")
    eng.prefill([seq[:40]], [0])
    eng.restore_slot(1, eng.snapshot_slot(0, 40))
    cont = eng.prefill_continue([seq[40:]], [1], [40])[0]
    cold = Engine(params, cfg, max_batch=1, kv_dtype=kv, seq_len=S, device="cpu")
    want = cold.prefill([seq], [0])[0]
    _close(cont, want, 1e-4 if kv == "int8" else TOL[kv])
    for n in eng.cache.arrays:
        got = getattr(eng.cache, n)[:, 1].float()
        ref = getattr(cold.cache, n)[:, 0].float()
        if n in ("k", "v") and kv == "int8":  # one int8 step where an f32 sum moves a rounding
            assert (got - ref).abs().max() <= 1
        else:
            _close(got.numpy(), ref.numpy(), 1e-4 if kv != "bfloat16" else TOL[kv])


@pytest.mark.parametrize("kv", ["int8", "float32", "bfloat16"])
def test_rows_that_fit_are_written_alike_with_and_without_the_guard(kv):
    """Where the caller knows that every row fits the cache, ``_write_rows``
    writes the rows straight; the guarded write (start on the card, not
    known to the host) gives the same cache there, to the bit."""
    cfg = ModelConfig(**TINY_GQA)
    B, T, S = 2, 8, 64
    g = torch.Generator().manual_seed(5)
    guarded = tl.make_kv_cache(cfg, B, kv_dtype=kv, seq_len=S, device="cpu")
    for n in guarded.arrays:
        a = getattr(guarded, n)
        a.copy_(torch.randint(-127, 128, a.shape, generator=g, dtype=torch.int8)
                if a.dtype == torch.int8 else torch.randn(a.shape, generator=g).to(a.dtype))
    straight = tl.make_kv_cache(cfg, B, kv_dtype=kv, seq_len=S, device="cpu")
    for n in guarded.arrays:
        getattr(straight, n).copy_(getattr(guarded, n))
    k, v = (torch.randn(B, T, cfg.n_kv_heads, cfg.head_dim, generator=g) for _ in range(2))
    fresh = tl._cache_rows(guarded, k, v)
    start = torch.tensor([0, S - T])
    tl._write_rows(guarded, 1, fresh, start, cfg, fits=False)
    tl._write_rows(straight, 1, fresh, start, cfg, fits=True)
    for n in guarded.arrays:
        assert torch.equal(getattr(guarded, n), getattr(straight, n)), n

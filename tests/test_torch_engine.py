"""Port parity for serving: ``Engine`` + ``ContinuousBatcher`` produce the
same token streams as the JAX package's on a tiny W8A8 / INT8-KV GQA config,
with the xla decode attention and with the deferred-flush ``flash_dma`` one
(K9 + K10) on both sides, and on fused layouts (TINY128, fused prefill body
K3/K4/K5 + the residual K1 in the port; the JAX engine's CPU prefill runs
its fused body with the xla attention wherever B * T is a multiple of 32).
Then the paths of the fifth slice: prefix reuse (restore + a continuation
at start_pos > 0), device sampling with multi-step chunks (JAX's threefry
keys, so sampled streams are equal too) and the chunked long admission.

The first admission is a group of four prompts in the 128 bucket, so on the
JAX side it runs the K7 slot scatter and (4 x 128 rows > 256) the K2 row
quant kernel; later requests join as slots free up.  Greedy and seeded
temperature / top-p requests, f32 activations: the streams must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import TINY128, TINY_GQA, build_fused_pair, build_pair
from tpu_llama.runtime import ContinuousBatcher as JaxBatcher
from tpu_llama.runtime import Engine as JaxEngine
from tpu_llama.runtime import Request as JaxRequest
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
from tpu_llama_torch.runtime.metrics import summarize

torch.set_num_threads(1)

CFG = dict(TINY_GQA, seq_len=256)


def _requests(cls):
    rng = np.random.default_rng(11)
    lens = [120, 100, 127, 90, 9, 40, 14]
    temps = [0.0, 0.8, 0.0, 1.0, 0.0, 0.7, 0.9]
    topps = [1.0, 1.0, 1.0, 0.9, 1.0, 0.95, 1.0]
    out = []
    for i, (n, t, p) in enumerate(zip(lens, temps, topps)):
        prompt = [int(v) for v in rng.integers(3, CFG["vocab_size"], n)]
        out.append(cls(prompt_tokens=prompt, steps=n + 1 + 10 + i, temperature=t,
                       topp=p, seed=100 + i))
    return out


def _serve_both(attn, fused=False):
    """The same requests through the JAX engine and the port's, both with
    ``attn`` (and fused layouts on TINY128 with ``fused``); returns (JAX
    requests, port requests, the port's plain-version counts)."""
    if fused:
        jcfg, jp, tcfg, tp = build_fused_pair(dict(TINY128, seq_len=256), jnp.float32, seed=21)
    else:
        jcfg, jp, tcfg, tp = build_pair(CFG, jnp.float32, seed=21)
    jeng = JaxEngine(jp, jcfg, max_batch=4, kv_dtype="int8", seq_len=256, attn=attn)
    jb = JaxBatcher(jeng)
    jreqs = _requests(JaxRequest)
    for r in jreqs:
        jb.submit(r)
    jb.run()
    _kernels.reset_counts()
    teng = Engine(tp, tcfg, max_batch=4, kv_dtype="int8", seq_len=256, attn=attn,
                  device="cpu")
    tb = ContinuousBatcher(teng)
    treqs = _requests(Request)
    for r in treqs:
        tb.submit(r)
    tb.run()
    return jreqs, treqs, dict(_kernels.PLAIN_CALLS)


@pytest.fixture(scope="module")
def streams():
    return _serve_both("xla")


@pytest.fixture(scope="module")
def streams_flash_dma():
    """The deferred-flush decode (K9 + K10) on both sides."""
    return _serve_both("flash_dma")


@pytest.fixture(scope="module")
def streams_fused():
    """Fused layouts, the deferred-flush decode on both sides."""
    return _serve_both("flash_dma", fused=True)


def test_engine_token_streams_equal_jax(streams):
    jreqs, treqs, _ = streams
    assert all(r.done for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.id, t.temperature)
    assert sum(len(r.out_tokens) for r in treqs) > 40


def test_engine_ran_every_op_and_reports(streams):
    _, treqs, plain = streams
    # the CPU engine's prefill attention is JAX's CPU one, "xla" (attention_prefill): no K6
    assert plain["K1"] > 0 and plain["K2"] > 0 and plain["K6"] == 0 and plain["K7"] >= 2
    rep = summarize(treqs)
    assert rep.n_requests == len(treqs) and rep.total_tokens > 0
    assert rep.ttft_p50_s > 0


def test_engine_flash_dma_token_streams_equal_jax(streams_flash_dma):
    jreqs, treqs, plain = streams_flash_dma
    assert all(r.done for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.id, t.temperature)
    assert sum(len(r.out_tokens) for r in treqs) > 40
    assert plain["K9"] > 0 and plain["K10"] > 0
    assert plain["K9"] == CFG["n_layers"] * plain["K10"] and plain["K19"] == 0


def test_engine_fused_token_streams_equal_jax(streams_fused):
    jreqs, treqs, plain = streams_fused
    assert all(r.done for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.id, t.temperature)
    assert sum(len(r.out_tokens) for r in treqs) > 40
    L = TINY128["n_layers"]
    # every admission group ran the fused prefill body: K7 once per group
    assert plain["K7"] >= 2 and plain["K5"] == plain["K4"] == L * plain["K7"]
    assert plain["K3"] == 2 * L * plain["K7"] and plain["K6"] == 0  # "xla" attention
    assert plain["K9"] == L * plain["K10"] and plain["K10"] > 0


def test_engine_decode_attn_and_rejects_unknown():
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=25)
    assert Engine(tp, tcfg, kv_dtype="int8", max_batch=2, seq_len=64, device="cpu").decode_attn == "xla"
    eng = Engine(tp, tcfg, kv_dtype="int8", max_batch=2, seq_len=64, attn="flash", device="cpu")
    assert eng.decode_attn == "flash"
    with pytest.raises(ValueError):
        Engine(tp, tcfg, kv_dtype="int8", max_batch=2, seq_len=64, attn="pallas", device="cpu")


def test_engine_prefill_groups_and_decode():
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=22)
    eng = Engine(tp, tcfg, kv_dtype="int8", max_batch=4, seq_len=64, device="cpu")
    prompts = [[1, 5, 6], [1] + list(range(3, 30)), [1, 7]]  # groups of 2 and 1
    last = eng.prefill(prompts, [2, 0, 3])
    assert last.shape == (3, tcfg.vocab_size) and last.dtype == np.float32
    # each slot's cache rows hold its prompt's K; slot 1 was never written
    assert eng.cache.ks[:, 1].abs().sum() == 0
    assert (eng.cache.ks[:, 0, :, :28] > 0).all() and (eng.cache.ks[:, 2, :, :3] > 0).all()
    one = Engine(tp, tcfg, kv_dtype="int8", max_batch=1, seq_len=64, device="cpu")
    alone = one.prefill([prompts[1]], [0])
    np.testing.assert_allclose(last[1], alone[0], rtol=0, atol=1e-5)
    tokens = np.array([4, 5, 0, 6])
    pos = np.array([28, 3, 0, 2])
    logits = eng.decode(tokens, pos)
    assert logits.shape == (4, tcfg.vocab_size) and np.isfinite(logits).all()
    eng.reset()
    assert eng.cache.k.abs().sum() == 0


def test_scheduler_stop_tokens_logprobs_and_priority():
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=24)
    eng = Engine(tp, tcfg, kv_dtype="int8", max_batch=1, seq_len=64, device="cpu")
    base = Request(prompt_tokens=[7, 8, 9], steps=12, temperature=0.0)
    b = ContinuousBatcher(eng)
    b.submit(base)
    free = b.run()[0].out_tokens
    assert len(free) == 12 - 4 + 1  # one token per step past the prompt
    seen = []
    stop = Request(prompt_tokens=[7, 8, 9], steps=12, temperature=0.0,
                   stop_tokens=(free[2],), logprobs=3, on_token=seen.append)
    b = ContinuousBatcher(eng, policy="priority")
    late = Request(prompt_tokens=[5], steps=4, temperature=0.0, priority=5)
    b.submit(late)
    b.submit(stop)
    done = b.run()
    assert done[0] is stop and done[1] is late  # priority 0 admits first
    assert stop.out_tokens == free[:2] == seen  # the stop token is not emitted
    assert len(stop.out_logprobs) == 2 and len(stop.out_top_logprobs[0]) == 3
    assert stop.out_top_logprobs[0][0][0] == free[0]  # greedy = top-1
    assert all(lp <= 0 for lp in stop.out_logprobs)


def test_scheduler_rejects_unported_paths():
    """The paged layout is ported with its pool-direct admission (a group
    above 8192 rows with T and the page size multiples of 256: K16 and K17,
    no compact block); an unknown layout is refused."""
    _, _, tcfg, tp = build_pair(dict(CFG, seq_len=2048), jnp.float32, seed=23)
    eng = Engine(tp, tcfg, kv_layout="paged", max_batch=8, page_size=256, device="cpu")
    before = _kernels.PLAIN_CALLS["K16"]
    last = eng.prefill([[1] * 1100] * 8, list(range(8)))
    assert last.shape == (8, tcfg.vocab_size) and _kernels.PLAIN_CALLS["K16"] > before
    with pytest.raises(ValueError):
        Engine(tp, tcfg, kv_dtype="int8", kv_layout="ragged", device="cpu")


# ---------------------------------------------------------------------------
# Prefix reuse (the contracts of tests/test_prefix_cache.py on the port)
# ---------------------------------------------------------------------------


def _prefix_engine(seed=30, **kw):
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=seed)
    return Engine(tp, tcfg, kv_dtype="int8", max_batch=4, seq_len=64, device="cpu", **kw)


def _run_one(batcher, prompt, steps=20, seed=1, **kw):
    req = Request(prompt_tokens=list(prompt), steps=steps, temperature=0.0, seed=seed, **kw)
    batcher.submit(req)
    batcher.run()
    return req.out_tokens


ONCE = [40, 41, 42, 43]
ONCE_UPON = ONCE + [50, 51, 52, 53, 54, 55, 56]


def test_identical_prompt_skips_prefill():
    eng = _prefix_engine()
    b = ContinuousBatcher(eng, prefix_cache_size=4)
    calls = {"prefill": 0, "continue": 0}
    prefill, cont = eng.prefill, eng.prefill_continue

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    eng.prefill, eng.prefill_continue = counted("prefill", prefill), counted("continue", cont)
    first = _run_one(b, ONCE_UPON)
    assert calls == {"prefill": 1, "continue": 0}
    second = _run_one(b, ONCE_UPON)
    assert calls == {"prefill": 1, "continue": 0}  # whole-prompt hit: no prefill at all
    assert b.prefix_hits == 1 and second == first and first


def test_shared_prefix_continues_with_start_pos():
    b0 = ContinuousBatcher(_prefix_engine())
    _run_one(b0, ONCE)
    want = _run_one(b0, ONCE_UPON)
    _kernels.reset_counts()
    b = ContinuousBatcher(_prefix_engine(), prefix_cache_size=4)
    _run_one(b, ONCE)  # seeds the cache with the prefix
    got = _run_one(b, ONCE_UPON)
    assert b.prefix_hits == 1 and got == want and want
    assert _kernels.PLAIN_CALLS["K7"] == 1  # the continuation wrote no block through K7


def test_prefix_cache_eviction():
    b = ContinuousBatcher(_prefix_engine(), prefix_cache_size=2)
    for p in ([40, 41], [42, 43], ONCE, [40, 41]):
        _run_one(b, p, steps=8)
    assert len(b._prefix) <= 2


def test_mixed_hit_miss_batch():
    eng = _prefix_engine()
    b = ContinuousBatcher(eng, prefix_cache_size=4)
    base = _run_one(b, ONCE)
    want_other = _run_one(ContinuousBatcher(_prefix_engine()), [60, 60, 61])
    r_hit = Request(prompt_tokens=ONCE, steps=20, temperature=0.0, seed=1)
    r_miss = Request(prompt_tokens=[60, 60, 61], steps=20, temperature=0.0, seed=1)
    b.submit(r_hit)
    b.submit(r_miss)
    b.run()
    assert r_hit.out_tokens == base and r_miss.out_tokens == want_other
    assert b.prefix_hits == 1


def test_snapshot_restore_round_trip():
    eng = _prefix_engine()
    eng.prefill([[1] + ONCE_UPON], [2])
    snap = eng.snapshot_slot(2, 8)
    eng.restore_slot(0, snap)
    for n in ("k", "v", "ks", "vs"):
        c = getattr(eng.cache, n)
        assert torch.equal(c[:, 0, :, :8], c[:, 2, :, :8]) and not c[:, 0, :, 8:].any()
    eng.release_snapshot(snap)


def _prefix_requests(cls, **kw):
    """Prompts sharing prefixes, submitted in two waves."""
    rng = np.random.default_rng(31)
    base = [[int(t) for t in rng.integers(3, CFG["vocab_size"], n)] for n in (20, 45)]
    first = [cls(prompt_tokens=p, steps=len(p) + 9, temperature=0.0, seed=5, **kw) for p in base]
    second = [cls(prompt_tokens=base[0] + [7, 8, 9], steps=40, temperature=0.8, seed=6, **kw),
              cls(prompt_tokens=base[1], steps=60, temperature=0.0, seed=7, **kw),
              cls(prompt_tokens=base[1] + list(range(20, 40)), steps=80, temperature=0.0,
                  seed=8, **kw)]
    return first, second


@pytest.mark.parametrize("device_sampling", [False, True], ids=["host", "device"])
def test_prefix_streams_equal_jax(device_sampling):
    """The JAX ContinuousBatcher and the port's, both with a prefix cache:
    the same hits, the same tokens."""
    jcfg, jp, tcfg, tp = build_pair(CFG, jnp.float32, seed=32)
    out = []
    for eng, cls, B in ((JaxEngine(jp, jcfg, max_batch=4, kv_dtype="int8", seq_len=128),
                         JaxRequest, JaxBatcher),
                        (Engine(tp, tcfg, kv_dtype="int8", max_batch=4, seq_len=128, device="cpu"), Request,
                         ContinuousBatcher)):
        b = B(eng, prefix_cache_size=4, max_chunk=4)
        first, second = _prefix_requests(cls, device_sampling=device_sampling)
        for wave in (first, second):
            for r in wave:
                b.submit(r)
            b.run()
        out.append(([r.out_tokens for r in first + second], b.prefix_hits))
    assert out[0] == out[1] and out[1][1] == 3


# ---------------------------------------------------------------------------
# Device sampling: JAX's threefry streams through the engine's chunks
# ---------------------------------------------------------------------------


def _device_requests(cls):
    out = _requests(cls)
    for i, r in enumerate(out):
        r.device_sampling = True
        r.topk = 40 if i % 3 == 2 else 0
    return out


@pytest.mark.parametrize("max_chunk", [1, 4])
def test_device_sampling_streams_equal_jax(max_chunk):
    jcfg, jp, tcfg, tp = build_pair(CFG, jnp.float32, seed=21)
    jb = JaxBatcher(JaxEngine(jp, jcfg, max_batch=4, kv_dtype="int8", seq_len=256),
                    max_chunk=max_chunk)
    jreqs = _device_requests(JaxRequest)
    for r in jreqs:
        jb.submit(r)
    jb.run()
    tb = ContinuousBatcher(Engine(tp, tcfg, kv_dtype="int8", max_batch=4, seq_len=256, device="cpu"),
                           max_chunk=max_chunk)
    treqs = _device_requests(Request)
    for r in treqs:
        tb.submit(r)
    tb.run()
    assert all(r.done for r in treqs)
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.id, t.temperature, t.topk)
    assert sum(len(r.out_tokens) for r in treqs) > 40
    if max_chunk > 1:
        assert tb.timers["chunks"] > 0 and tb.timers["chunk_steps"] > tb.timers["chunks"]
        assert tb.timers["decode_steps"] >= tb.timers["chunk_steps"]


def test_mixed_host_and_device_sampling_batch():
    """Host- and device-sampled requests in one batch: each stream equals
    the one it gets alone."""
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=26)

    def serve(reqs):
        b = ContinuousBatcher(Engine(tp, tcfg, kv_dtype="int8", max_batch=4, seq_len=64, device="cpu"),
                              max_chunk=4)
        for r in reqs:
            b.submit(r)
        b.run()
        return [r.out_tokens for r in reqs]

    def reqs():
        return [Request(prompt_tokens=[5, 6, 7], steps=20, temperature=0.9, seed=3,
                        device_sampling=True),
                Request(prompt_tokens=[8, 9], steps=20, temperature=0.9, seed=4)]

    both = serve(reqs())
    assert both == [serve([r])[0] for r in reqs()]


def test_engine_device_sampling_calls():
    """decode_sample_chunk equals step-at-a-time decode_sample with keys
    fold_in(key(seed), position); the async form returns a tensor."""
    from tpu_llama_torch.ops import sampling as ts

    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=27)
    B, k = 2, 3
    args = (np.ones(B, np.float32) * 0.9, np.ones(B, np.float32), ts.keys_numpy([1, 2]))
    chunks = []
    for step_wise in (False, True):
        eng = Engine(tp, tcfg, kv_dtype="int8", max_batch=B, seq_len=64, device="cpu")
        eng.prefill([[1, 5, 6], [1, 7]], [0, 1])
        toks, pos = np.array([9, 10]), np.array([3, 2])
        if not step_wise:
            out = eng.decode_sample_chunk_async(toks, pos, *args, k)
            assert isinstance(out, torch.Tensor) and out.shape == (B, k)
            chunks.append(out.numpy())
            continue
        got = []
        for _ in range(k):
            keys = ts.fold_in(torch.tensor(args[2]), torch.tensor(pos))
            toks = eng.decode_sample(toks, pos, args[0], args[1], keys)
            got.append(toks)
            pos = pos + 1
        chunks.append(np.stack(got, axis=1))
    np.testing.assert_array_equal(chunks[0], chunks[1])


# ---------------------------------------------------------------------------
# Long admission: above 8192 prompt rows the block is prefilled in chunks
# ---------------------------------------------------------------------------


def test_long_admission_chunked_streams_equal_jax():
    """8 prompts of 1100-2000 tokens bucket to one group of 8 x 2048 rows
    (> 8192): both engines run their chunked prefill (chunks of 256), on
    unfused layouts, where both sides run the same f32 math; greedy
    streams must be equal."""
    cfg = dict(TINY_GQA, seq_len=2048)
    jcfg, jp, tcfg, tp = build_pair(cfg, jnp.float32, seed=28)
    lens = [1100, 2000, 1500, 1999, 1234, 1800, 1650, 1420]

    def reqs(cls):
        rng = np.random.default_rng(29)
        return [cls(prompt_tokens=[int(t) for t in rng.integers(3, cfg["vocab_size"], n - 1)],
                    steps=n + 4, temperature=0.0) for n in lens]

    jb = JaxBatcher(JaxEngine(jp, jcfg, max_batch=8, kv_dtype="int8", seq_len=2048))
    jreqs = reqs(JaxRequest)
    for r in jreqs:
        jb.submit(r)
    jb.run()
    _kernels.reset_counts()
    tb = ContinuousBatcher(Engine(tp, tcfg, kv_dtype="int8", max_batch=8, seq_len=2048, device="cpu"))
    treqs = reqs(Request)
    for r in treqs:
        tb.submit(r)
    tb.run()
    plain = dict(_kernels.PLAIN_CALLS)
    assert plain["K7"] == 1 and plain["K6"] == 0  # "xla" attention, as JAX's on the CPU
    assert tb.timers["admits"] == 1
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens and len(t.out_tokens) == 5


def test_engine_prefill_attn():
    """``Engine(prefill_attn=...)``: "auto" resolves to "xla" on the CPU
    (the JAX engine's CPU prefill, no K6); an explicit "flash" admits
    through K6's plain version, the card's function, on every layer."""
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=25)
    prompts = [[1, 5, 9, 2], [1, 7]]
    for attn, want in (("auto", "xla"), ("xla", "xla"), ("flash", "flash")):
        eng = Engine(tp, tcfg, max_batch=2, kv_dtype="int8", device="cpu", prefill_attn=attn)
        assert eng.prefill_attn == want
        _kernels.reset_counts()
        eng.prefill(prompts, [0, 1])
        assert _kernels.PLAIN_CALLS["K6"] == (tcfg.n_layers if want == "flash" else 0)
    with pytest.raises(ValueError):
        Engine(tp, tcfg, device="cpu", prefill_attn="flash_dma")

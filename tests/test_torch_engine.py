"""Port parity for serving: ``Engine`` + ``ContinuousBatcher`` produce the
same token streams as the JAX package's on a tiny W8A8 / INT8-KV GQA config,
with the xla decode attention and with the deferred-flush ``flash_dma`` one
(K9 + K10) on both sides, and on fused layouts (TINY128, fused prefill body
K3/K4/K5 + the residual K1 in the port; the JAX engine's CPU prefill runs
its fused body with the xla attention wherever B * T is a multiple of 32).

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
    assert plain["K1"] > 0 and plain["K2"] > 0 and plain["K6"] > 0 and plain["K7"] >= 2
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
    assert plain["K3"] == 2 * L * plain["K7"] and plain["K6"] == L * plain["K7"]
    assert plain["K9"] == L * plain["K10"] and plain["K10"] > 0


def test_engine_decode_attn_and_rejects_unknown():
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=25)
    assert Engine(tp, tcfg, max_batch=2, seq_len=64, device="cpu").decode_attn == "xla"
    eng = Engine(tp, tcfg, max_batch=2, seq_len=64, attn="flash", device="cpu")
    assert eng.decode_attn == "flash"
    with pytest.raises(ValueError):
        Engine(tp, tcfg, max_batch=2, seq_len=64, attn="pallas", device="cpu")


def test_engine_prefill_groups_and_decode():
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=22)
    eng = Engine(tp, tcfg, max_batch=4, seq_len=64, device="cpu")
    prompts = [[1, 5, 6], [1] + list(range(3, 30)), [1, 7]]  # groups of 2 and 1
    last = eng.prefill(prompts, [2, 0, 3])
    assert last.shape == (3, tcfg.vocab_size) and last.dtype == np.float32
    # each slot's cache rows hold its prompt's K; slot 1 was never written
    assert eng.cache.ks[:, 1].abs().sum() == 0
    assert (eng.cache.ks[:, 0, :, :28] > 0).all() and (eng.cache.ks[:, 2, :, :3] > 0).all()
    one = Engine(tp, tcfg, max_batch=1, seq_len=64, device="cpu")
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
    eng = Engine(tp, tcfg, max_batch=1, seq_len=64, device="cpu")
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
    _, _, tcfg, tp = build_pair(CFG, jnp.float32, seed=23)
    eng = Engine(tp, tcfg, max_batch=2, seq_len=64, device="cpu")
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(eng, prefix_cache_size=2)
    with pytest.raises(NotImplementedError):
        ContinuousBatcher(eng).submit(Request(prompt_tokens=[5], device_sampling=True))
    with pytest.raises(NotImplementedError):
        Engine(tp, tcfg, kv_layout="paged", device="cpu")
    with pytest.raises(NotImplementedError):
        Engine(tp, tcfg, max_batch=8, seq_len=2048, device="cpu").prefill(
            [[1] * 1500] * 8, list(range(8)))

"""The port's serving front door on the CPU (``device="cpu"``, port 0):

* ``runtime.server.LlamaServer``: tests/test_server.py's contracts (health,
  determinism, concurrency, metrics, bad requests, the journal and crash
  recovery, streaming with and without logprobs, warmup), and greedy
  ``/generate`` tokens equal to the JAX package's ``LlamaServer`` for the
  same prompts;
* ``Engine.warmup``: JAX's bucket list on dense and paged engines, the
  engine left clean;
* ``runtime.health``: tests/test_health.py's contracts on the port's
  ``Request``;
* ``utils.EngineConfig``: round-trips, rejects unknown keys, loads a JSON
  that the JAX package's ``EngineConfig`` saved, builds dense and paged
  engines (and defaults to the card); ``utils.profile_trace``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from tpu_llama.models import params_from_raw as jax_params_from_raw
from tpu_llama.runtime import Engine as JaxEngine
from tpu_llama.runtime.server import LlamaServer as JaxServer
from tpu_llama.utils import EngineConfig as JaxEngineConfig
from tpu_llama_torch import convert
from tpu_llama_torch.io import tokenizer as ttok
from tpu_llama_torch.io import write_checkpoint
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
from tpu_llama_torch.runtime.health import RequestLog, Watchdog
from tpu_llama_torch.runtime.server import LlamaServer
from tpu_llama_torch.utils import EngineConfig, profile_trace

torch.set_num_threads(1)


def _tokenizer(tiny_tokenizer):
    return ttok.Tokenizer(tiny_tokenizer.vocab, tiny_tokenizer.scores,
                          raw_bytes=tiny_tokenizer.raw_bytes)


def _engine(tiny_weights, **kw):
    raw = convert.raw_weights_from(tiny_weights)
    return Engine(tl.params_from_raw(raw, device="cpu"), raw.config, max_batch=2,
                  precision="highest", device="cpu", **kw)


@pytest.fixture(scope="module")
def server(tiny_weights, tiny_tokenizer):
    srv = LlamaServer(_engine(tiny_weights), _tokenizer(tiny_tokenizer), port=0).start()
    yield srv
    srv.stop()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _stream(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(dict(payload, stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    events, done = [], None
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        for line in r:
            event = json.loads(line)
            if event.get("done"):
                done = event
            else:
                events.append(event)
    return events, done


# ---- LlamaServer: tests/test_server.py's contracts ----

def test_healthz(server):
    status, body = _get(server.port, "/healthz")
    assert status == 200 and body == {"ok": True, "active": 0, "queued": 0}


def test_generate_deterministic(server):
    payload = dict(prompt="Once upon a time", steps=16, temperature=0.0, seed=1)
    s1, r1 = _post(server.port, "/generate", payload)
    s2, r2 = _post(server.port, "/generate", payload)
    assert s1 == s2 == 200
    assert r1["tokens"] == r2["tokens"] and r1["text"] == r2["text"]
    assert r1["n_tokens"] == len(r1["tokens"]) > 0
    assert r1["ttft_s"] >= 0


def test_concurrent_requests(server):
    results = {}

    def call(i):
        results[i] = _post(server.port, "/generate",
                           dict(prompt="On", steps=12, temperature=0.0, seed=1))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    toks = [results[i][1]["tokens"] for i in range(4)]
    assert all(t == toks[0] for t in toks)  # the same request, the same answer


def test_metrics_endpoint(server):
    _post(server.port, "/generate", dict(prompt="On", steps=8, temperature=0.0))
    status, body = _get(server.port, "/metrics")
    assert status == 200
    assert body["n_requests"] == len(server.batcher.finished) >= 1
    assert body["tokens_per_sec"] >= 0


def test_bad_request(server):
    for data in (b'{"steps": "NaN-ish"}', b"{not json"):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/generate", data=data,
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.port, "/nope")
    assert e.value.code == 404


def test_unknown_prompt_character_is_a_bad_request(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, "/generate", dict(prompt="\U0001F600", steps=4))
    assert e.value.code == 400


def test_streaming_generate(server):
    """stream=true: ndjson piece events, then a done summary; the pieces
    concatenate to the non-streamed text."""
    payload = dict(prompt="Once", steps=14, temperature=0.0, seed=1)
    plain = _post(server.port, "/generate", payload)[1]
    events, done = _stream(server.port, payload)
    assert done is not None and done["n_tokens"] == plain["n_tokens"]
    assert "".join(e["piece"] for e in events) == plain["text"]


def test_streaming_logprobs(server):
    payload = dict(prompt="Once", steps=12, temperature=0.0, seed=1, logprobs=2)
    plain = _post(server.port, "/generate", payload)[1]
    events, done = _stream(server.port, payload)
    assert done is not None and done["n_tokens"] == plain["n_tokens"]
    assert [e["token"] for e in events] == plain["tokens"]
    assert [e["logprob"] for e in events] == plain["logprobs"]
    for e in events:
        assert len(e["top_logprobs"]) == 2
        assert e["top_logprobs"][0]["token"] == e["token"]  # greedy == top-1


def test_generate_logprobs(server):
    status, body = _post(server.port, "/generate", {"prompt": "Once", "steps": 10,
                                                    "temperature": 0.0, "seed": 1,
                                                    "logprobs": 2})
    assert status == 200
    assert len(body["logprobs"]) == len(body["top_logprobs"]) == body["n_tokens"] > 0
    for tok, lp, alts in zip(body["tokens"], body["logprobs"], body["top_logprobs"]):
        assert lp <= 0.0 and len(alts) == 2
        assert alts[0]["token"] == tok


def test_device_sampling_request(server):
    status, body = _post(server.port, "/generate", dict(prompt="Once", steps=12,
                                                        temperature=0.8, seed=5,
                                                        device_sampling=True, topk=8))
    assert status == 200 and all(0 <= t < 320 for t in body["tokens"])


def test_server_journal_and_recovery(tmp_path, tiny_weights, tiny_tokenizer):
    """The server journals its requests; a restarted server re-serves the
    unfinished ones."""
    log_path = tmp_path / "reqlog.jsonl"
    tok = _tokenizer(tiny_tokenizer)
    engine = _engine(tiny_weights)
    srv = LlamaServer(engine, tok, port=0, request_log=str(log_path), watchdog_s=30).start()
    _, first = _post(srv.port, "/generate", dict(prompt="On", steps=8, temperature=0.0, seed=1))
    srv.stop()
    lines = [json.loads(line) for line in log_path.read_text().splitlines()]
    assert {line["type"] for line in lines} == {"submit", "done"}
    # a crash: a submit with no done, then a restart
    with open(log_path, "a") as f:
        f.write(json.dumps({"type": "submit", "id": 999, "prompt_tokens": tok.encode("On"),
                            "steps": 8, "temperature": 0.0, "topp": 1.0, "seed": 1}) + "\n")
    engine.reset()
    srv2 = LlamaServer(engine, tok, port=0, request_log=str(log_path)).start()
    deadline = time.time() + 60
    while time.time() < deadline and not srv2.batcher.finished:
        time.sleep(0.02)
    srv2.stop()
    assert len(srv2.batcher.finished) == 1  # the crashed request was re-served
    assert srv2.batcher.finished[0].out_tokens == first["tokens"]


def test_scheduler_fault_fails_requests_at_once(tiny_weights, tiny_tokenizer):
    """An exception in the scheduler thread fails the waiting request and
    every later one with a 500 (no wait for the timeout); /healthz says
    so."""
    engine = _engine(tiny_weights)

    def broken(*a, **k):
        raise RuntimeError("injected fault")

    engine.prefill = broken
    srv = LlamaServer(engine, _tokenizer(tiny_tokenizer), port=0).start()
    try:
        t0 = time.time()
        for _ in range(2):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, "/generate", dict(prompt="On", steps=8, temperature=0.0))
            assert e.value.code == 500 and b"injected fault" in e.value.read()
        assert time.time() - t0 < 30
        assert _get(srv.port, "/healthz")[1]["ok"] is False
    finally:
        srv.stop()


def test_greedy_tokens_equal_jax_server(server, tiny_weights, tiny_tokenizer):
    jsrv = JaxServer(JaxEngine(jax_params_from_raw(tiny_weights), tiny_weights.config,
                               max_batch=2, precision="highest"), tiny_tokenizer, port=0).start()
    try:
        for prompt, steps in (("Once upon a time", 24), ("On", 12), ("", 10)):
            payload = dict(prompt=prompt, steps=steps, temperature=0.0, seed=1)
            want = _post(jsrv.port, "/generate", payload)[1]
            got = _post(server.port, "/generate", payload)[1]
            assert got["tokens"] == want["tokens"] and got["text"] == want["text"], prompt
    finally:
        jsrv.stop()


# ---- Engine.warmup ----

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_warmup_buckets_equal_jax(layout, tiny_weights, tiny_tokenizer):
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    sample = layout == "dense"
    je = JaxEngine(jax_params_from_raw(tiny_weights), tiny_weights.config, max_batch=2,
                   precision="highest", **kw)
    te = _engine(tiny_weights, **kw)
    buckets = te.warmup(chunk=2, sample=sample)
    assert buckets == je.warmup(chunk=2, sample=sample) == [16, 32, 64]
    assert te.warmup(max_bucket=40, sample=False) == [16, 32, 40]
    assert te.warmup(max_bucket=1000, sample=False) == [16, 32, 64]  # capped at seq_len
    if layout == "paged":
        assert te.pool.free_pages == te.pool.num_pages - 1
    else:
        assert not te.cache.k.any() and not te.cache.v.any()
    # the engine serves as a fresh one would
    srv = LlamaServer(te, _tokenizer(tiny_tokenizer), port=0, warmup=True, max_chunk=2).start()
    try:
        assert srv.warmup_buckets == buckets
        status, body = _post(srv.port, "/generate", dict(prompt="Once", steps=8,
                                                         temperature=0.0, seed=1))
        assert status == 200 and body["n_tokens"] > 0
    finally:
        srv.stop()
    fresh = ContinuousBatcher(_engine(tiny_weights, **kw))
    r = Request(prompt_tokens=_tokenizer(tiny_tokenizer).encode("Once"), steps=8,
                temperature=0.0, seed=1)
    fresh.submit(r)
    fresh.run()
    assert body["tokens"] == r.out_tokens


# ---- runtime.health: tests/test_health.py's contracts ----

def _watchdog_run(threshold, beats, active, wait):
    fired = []
    wd = Watchdog(threshold_s=threshold, on_stall=lambda: fired.append(1), poll_s=0.05).start()
    for _ in range(beats):
        wd.beat(active=True)
        time.sleep(0.05)
    wd.beat(active=active)
    time.sleep(wait)
    wd.stop()
    return fired, wd


def test_watchdog_fires_on_stall():
    fired, wd = _watchdog_run(0.2, 0, True, 0.6)  # no beats while active
    assert fired == [1] and wd.fired


def test_watchdog_quiet_when_beating():
    fired, wd = _watchdog_run(0.3, 10, True, 0.0)
    assert fired == [] and not wd.fired


def test_watchdog_quiet_when_idle():
    fired, _ = _watchdog_run(0.2, 0, False, 0.5)  # idle: no work in flight
    assert fired == []


def test_request_log_replay(tmp_path):
    path = tmp_path / "requests.jsonl"
    log = RequestLog(path)
    reqs = [Request(prompt_tokens=[1, 2, 3], steps=10, seed=s) for s in (1, 2, 3)]
    for i, r in enumerate(reqs):
        r.id = i
        log.log_submit(r)
    reqs[1].out_tokens = [7, 8]
    log.log_done(reqs[1])  # only request 1 finished before the crash
    log.close()
    pending = RequestLog.replay_incomplete(path)
    assert [p.seed for p in pending] == [1, 3]
    assert pending[0].prompt_tokens == [1, 2, 3] and isinstance(pending[0], Request)


def test_request_log_empty(tmp_path):
    assert RequestLog.replay_incomplete(tmp_path / "nope.jsonl") == []


def test_crash_recovery_end_to_end(tmp_path, tiny_weights, tiny_tokenizer):
    """A journaled request that never finished, re-served by a fresh engine,
    gives the tokens of a run that never crashed."""
    path = tmp_path / "requests.jsonl"
    ptoks = _tokenizer(tiny_tokenizer).encode("Once upon a time")
    log = RequestLog(path)
    req = Request(prompt_tokens=ptoks, steps=20, temperature=0.0, seed=1)
    req.id = 0
    log.log_submit(req)
    log.close()  # the crash: no 'done' record
    engine = _engine(tiny_weights)
    batcher = ContinuousBatcher(engine)
    (pending,) = RequestLog.replay_incomplete(path)
    batcher.submit(pending)
    batcher.run()
    assert pending.done
    engine.reset()
    b2 = ContinuousBatcher(engine)
    fresh = Request(prompt_tokens=ptoks, steps=20, temperature=0.0, seed=1)
    b2.submit(fresh)
    b2.run()
    assert pending.out_tokens == fresh.out_tokens


def test_replay_preserves_sampling_and_stop_semantics(tmp_path):
    log = RequestLog(tmp_path / "req.jsonl")
    req = Request(prompt_tokens=[5, 6], steps=12, temperature=0.8, topp=0.9, seed=7,
                  device_sampling=True, topk=4, stop_tokens=(2,))
    req.id = 0
    log.log_submit(req)
    log.close()
    (replayed,) = RequestLog.replay_incomplete(tmp_path / "req.jsonl")
    assert (replayed.device_sampling, replayed.topk, replayed.stop_tokens) == (True, 4, (2,))
    assert (replayed.temperature, replayed.topp, replayed.seed) == (0.8, 0.9, 7)


# ---- utils: EngineConfig and profile_trace ----

def test_engine_config_roundtrip(tmp_path):
    cfg = EngineConfig(checkpoint="m.bin", quant="int8", max_batch=16, kv_dtype="int8",
                       mesh_model=4, device="cpu")
    cfg.server.port = 9999
    cfg.save(tmp_path / "engine.json")
    assert EngineConfig.load(tmp_path / "engine.json") == cfg
    assert EngineConfig().device == "cuda"


def test_engine_config_rejects_unknown(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text('{"checkpoint": "x", "bogus_knob": 1}')
    with pytest.raises(ValueError, match="bogus_knob"):
        EngineConfig.load(path)


def test_engine_config_loads_jax_json(tmp_path):
    """Every field of a JSON saved by the JAX package's EngineConfig loads
    into the port's, which adds only ``device`` (default the card)."""
    jcfg = JaxEngineConfig(checkpoint="m.bin", tokenizer="t.bin", quant="w8a8",
                           kv_dtype="int8", max_batch=4, precision="highest", seq_len=512,
                           kv_layout="paged", page_size=16, num_pages=9, attn="flash",
                           fuse=False, mesh_data=1, mesh_model=2)
    jcfg.server.port, jcfg.server.request_log, jcfg.server.watchdog_s = 9000, "r.jsonl", 30.0
    jcfg.save(tmp_path / "jax.json")
    cfg = EngineConfig.load(tmp_path / "jax.json")
    for f in ("checkpoint", "tokenizer", "quant", "kv_dtype", "max_batch", "precision",
              "seq_len", "kv_layout", "page_size", "num_pages", "attn", "fuse", "mesh_data",
              "mesh_model"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.server) == vars(jcfg.server)
    assert cfg.device == "cuda"


@pytest.mark.parametrize("kind", ["dense_int8", "paged", "w8a8"])
def test_engine_config_build(kind, tmp_path, tiny_weights, tiny_tokenizer):
    write_checkpoint(tmp_path / "model.bin", convert.raw_weights_from(tiny_weights))
    _tokenizer(tiny_tokenizer).save(tmp_path / "tok.bin")
    kw = dict(dense_int8=dict(quant="int8"), paged=dict(kv_layout="paged", page_size=8),
              w8a8=dict(quant="w8a8", kv_dtype="int8"))[kind]
    cfg = EngineConfig(checkpoint=str(tmp_path / "model.bin"), tokenizer=str(tmp_path / "tok.bin"),
                       max_batch=2, precision="highest", device="cpu", **kw)
    cfg.save(tmp_path / "engine.json")
    engine, tok = EngineConfig.load(tmp_path / "engine.json").build_engine()
    assert engine.max_batch == 2 and engine.device.type == "cpu"
    assert tok.vocab_size == tiny_weights.config.vocab_size
    assert (engine.pool is not None and engine.pool.page_size == 8) == (kind == "paged")
    assert tl._fused_layouts(engine.params.layers, engine.config)
    b = ContinuousBatcher(engine)
    r = Request(prompt_tokens=tok.encode("Once"), steps=8, temperature=0.0)
    b.submit(r)
    b.run()
    assert r.done and r.out_tokens


def test_engine_config_refuses_what_it_cannot_build(tmp_path, tiny_weights, tiny_tokenizer):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(mesh_model=2, kv_layout="paged", device="cpu").build_engine()
    with pytest.raises(ValueError, match="unknown quant"):
        EngineConfig(quant="int4", device="cpu").build_engine()
    if torch.cuda.is_available():
        return  # the no-card behaviour is not observable
    write_checkpoint(tmp_path / "model.bin", convert.raw_weights_from(tiny_weights))
    _tokenizer(tiny_tokenizer).save(tmp_path / "tok.bin")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineConfig(checkpoint=str(tmp_path / "model.bin"),
                     tokenizer=str(tmp_path / "tok.bin")).build_engine()


def test_profile_trace_noop_and_capture(tmp_path):
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "trace")):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum().item()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])

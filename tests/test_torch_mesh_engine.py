"""The port's mesh engines on the CPU: ``Engine(mesh)`` (the sharded engine,
JAX's GSPMD single program) and ``Engine(mesh, tp_fused=True)``, served by
``ContinuousBatcher`` on every rank (SPMD) and through one controller process
(``parallel.launch.MeshEngine``), ``EngineConfig.build_engine`` and
``serve_cli --config`` with a mesh, ``dryrun_multichip`` and the controller's
failure path.

Contracts, and their sources:

* tests/test_runtime.py:217: ``Engine(mesh)`` + ``ContinuousBatcher``
  equals the unsharded engine token for token (f32 weights, "highest");
  here also with prefix hits (a prompt that extends an earlier one's, its
  KV restored and its suffix continued), with W8A8 weights over an INT8
  cache, at dp = 2 (the snapshot broadcast over ``data``), and through the
  controller, with host and device sampling;
* the ``tp_fused`` engine keeps its prefix cache: a prefix hit's stream
  equals a cold admission's (JAX's engine, engine.py:581-613);
* ``prefill_with_all_logits`` on both mesh engines: every position's logits
  within the f32 limit of the unsharded engine's (the sharded engine; JAX's
  sharded-against-single-device rtol 1e-5 / atol 1e-6) or, on the
  ``tp_fused`` engine (per-shard activation quants, another function than
  the unsharded one), the last row bit for bit the same engine's admission
  logits for that prompt;
* tests/test_tp_engine.py:101: ``build_engine`` takes the ``tp_fused``
  engine exactly where JAX's rule does.
The ranks are gloo processes on the CPU (``launch.run``, ``RankPool``).
"""

import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_llama.utils import EngineConfig as JaxEngineConfig
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.io import tokenizer as ttok
from tpu_llama_torch.io import write_checkpoint
from tpu_llama_torch.io.checkpoint import make_random_weights
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.parallel import MeshConfig, launch
from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
from tpu_llama_torch.runtime.server import LlamaServer
from tpu_llama_torch.utils import EngineConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240
TINY = ModelConfig(dim=48, hidden_dim=128, n_layers=3, n_heads=4, n_kv_heads=4,
                   vocab_size=320, seq_len=64, shared_weights=True)  # tests/conftest.py
C256 = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2,
                   vocab_size=256, seq_len=64)  # tests/test_tp_engine.py
SEED, TP_SEED = 1234, 29
# the third prompt extends the first: with two slots it is admitted after
# the first's prefix is cached, and hits it
REQS = [([5, 9, 13, 22, 40], 20), ([7, 2], 12), ([5, 9, 13, 22, 40, 41, 42], 20),
        ([11, 3, 8, 4], 15)]
ALL = ([1, 5, 9, 13, 60, 61], 1)  # (prompt, slot) of prefill_with_all_logits


def _serve_calls(tp_cases: bool):
    calls = [("spmd", launch.mesh_serve,
              dict(config=TINY, seed=SEED, requests=REQS, max_batch=2, prefix_cache_size=4,
                   all_logits=ALL, precision="highest")),
             ("spmd_w8a8", launch.mesh_serve,
              dict(config=TINY, seed=SEED, requests=REQS, max_batch=2, quant="w8a8",
                   kv_dtype="int8", prefix_cache_size=4))]
    if tp_cases:
        tp = dict(config=C256, seed=TP_SEED, requests=REQS, max_batch=2, tp_fused=True,
                  kv_dtype="int8")
        calls += [("tp", launch.mesh_serve, dict(tp, prefix_cache_size=4, all_logits=ALL)),
                  ("tp_cold", launch.mesh_serve, tp)]
    return calls


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(dp, tp):
        if (dp, tp) not in cache:
            cache[dp, tp] = launch.run(launch.batch, MeshConfig(dp, tp),
                                       args=(_serve_calls((dp, tp) == (1, 2)),),
                                       backend="gloo", device="cpu", timeout=TIMEOUT)
        return cache[dp, tp]

    return get


def _params(quant=None):
    p = tl.params_from_raw(make_random_weights(TINY, seed=SEED), device="cpu")
    return p if quant is None else tl.quantize_params(p, mode=quant)


def _unsharded(quant=None, kv="float32", prefix=4, all_logits=False):
    eng = Engine(_params(quant), TINY, max_batch=2, kv_dtype=kv, precision="highest",
                 device="cpu")
    out = launch.serve_waves(eng, [REQS], prefix_cache_size=prefix)
    if all_logits:
        out["all_logits"] = eng.prefill_with_all_logits(*ALL)
    return out


@pytest.fixture(scope="module")
def reference():
    return {"f32": _unsharded(all_logits=True), "w8a8": _unsharded("w8a8", "int8"),
            "cold": _unsharded(prefix=0)}


def test_reference_hits_its_prefix(reference):
    """The requests exercise prefix reuse: the unsharded engine hits once
    and its streams equal a cold run's."""
    assert reference["f32"]["prefix_hits"] >= 1
    assert reference["f32"]["streams"] == reference["cold"]["streams"]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case,ref", [("spmd", "f32"), ("spmd_w8a8", "w8a8")])
def test_sharded_engine_serves_like_unsharded(runs, reference, mesh_shape, case, ref):
    """Every rank's batcher on ``Engine(mesh)`` serves the unsharded
    engine's streams token for token, prefix hits included; rank 0 alone
    emits."""
    ranks = runs(*mesh_shape)
    want = reference[ref]
    for r in ranks:
        assert r[case]["streams"] == want["streams"]
        assert r[case]["prefix_hits"] == want["prefix_hits"] >= 1
    assert len(ranks[0][case]["emitted"]) == sum(len(s) for s in want["streams"])
    assert all(not r[case]["emitted"] for r in ranks[1:])


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_engine_all_logits(runs, reference, mesh_shape):
    """``prefill_with_all_logits`` on the sharded engine: every position
    within the f32 limit of the unsharded engine's, and its last row the
    admission's logits for the prompt."""
    got = runs(*mesh_shape)[0]["spmd"]
    want = reference["f32"]["all_logits"]
    assert got["all_logits"].shape == (len(ALL[0]), TINY.vocab_size)
    np.testing.assert_allclose(got["all_logits"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["last_logits"], got["all_logits"][-1], rtol=1e-5, atol=1e-6)


def test_tp_fused_engine_prefix_hit_and_all_logits(runs):
    """The ``tp_fused`` engine keeps its prefix cache (a TP continuation
    prefill): its streams with a hit equal a cold run's; its all-position
    logits end in its admission's logits, bit for bit; ranks agree."""
    ranks = runs(1, 2)
    hot, cold = ranks[0]["tp"], ranks[0]["tp_cold"]
    assert hot["prefix_hits"] >= 1 and cold["prefix_hits"] == 0
    assert hot["streams"] == cold["streams"]
    assert all(r["tp"]["streams"] == hot["streams"] for r in ranks)
    assert hot["all_logits"].shape == (len(ALL[0]), C256.vocab_size)
    np.testing.assert_array_equal(hot["all_logits"][-1], hot["last_logits"])


def test_engine_with_mesh_sharded_cache_1x4(tiny_tokenizer):
    """tests/test_runtime.py:217 at (1, 4): one greedy request of 20 steps
    on ``Engine(mesh)`` equals the unsharded engine's, token for token."""
    prompt = tiny_tokenizer.encode("Once upon a time")
    call = ("s", launch.mesh_serve, dict(config=TINY, seed=SEED, requests=[(prompt, 20)],
                                         max_batch=4, precision="highest"))
    ranks = [r["s"] for r in launch.run(launch.batch, MeshConfig(1, 4), args=([call],),
                                        backend="gloo", device="cpu", timeout=TIMEOUT)]
    eng = Engine(_params(), TINY, max_batch=4, precision="highest", device="cpu")
    want = launch.serve_waves(eng, [[(prompt, 20)]])["streams"]
    assert all(r["streams"] == want for r in ranks)


# ---------------------------------------------------------------- the controller


@pytest.fixture(scope="module")
def controller():
    eng = launch.MeshEngine(launch.build_spmd_engine, (TINY, SEED),
                            dict(max_batch=2, precision="highest"),
                            mesh_config=MeshConfig(1, 2), device="cpu", timeout=TIMEOUT)
    yield eng
    eng.close()


def test_controller_batcher_serves_like_unsharded(controller, reference):
    """``ContinuousBatcher`` in this process on the controller: the unsharded
    engine's streams and prefix hits; the engine's settings are rank 0's."""
    assert controller.spmd and not controller.tp_fused and controller.max_batch == 2
    assert controller.decode_attn == "xla" and controller.decode_fused is False
    got = launch.serve_waves(controller, [REQS], prefix_cache_size=4)
    assert got["streams"] == reference["f32"]["streams"]
    assert got["prefix_hits"] == reference["f32"]["prefix_hits"]


@pytest.mark.parametrize("max_chunk", [1, 4])
def test_controller_device_sampling(controller, max_chunk):
    """Device-sampled requests (``decode_sample`` and the chunked
    ``decode_sample_chunk_async`` through the controller; the admission's
    ``sample_logits``): the unsharded engine's streams."""
    def serve(eng):
        b = ContinuousBatcher(eng, max_chunk=max_chunk)
        reqs = [Request(prompt_tokens=list(p), steps=s, temperature=0.9, topp=0.9, seed=7 + i,
                        device_sampling=True) for i, (p, s) in enumerate(REQS)]
        for r in reqs:
            b.submit(r)
        b.run()
        return [r.out_tokens for r in reqs]

    want = serve(Engine(_params(), TINY, max_batch=2, precision="highest", device="cpu"))
    controller.reset()
    assert serve(controller) == want


def _post_generate(port: int, payload: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _server_generate(eng, tok, payload: dict) -> dict:
    srv = LlamaServer(eng, tok, port=0).start()
    try:
        return _post_generate(srv.port, payload)
    finally:
        srv.stop()


def test_server_over_controller(controller, tiny_tokenizer):
    """``LlamaServer`` on the controller answers /generate with the unsharded
    engine's greedy text."""
    tok = ttok.Tokenizer(tiny_tokenizer.vocab, tiny_tokenizer.scores,
                         raw_bytes=tiny_tokenizer.raw_bytes)
    payload = {"prompt": "Once upon", "steps": 24, "temperature": 0.0}
    controller.reset()
    got = _server_generate(controller, tok, payload)
    want = _server_generate(Engine(_params(), TINY, max_batch=2, precision="highest",
                                   device="cpu"), tok, payload)
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]


def test_controller_raises_and_ends_every_rank():
    """A rank that fails ends the call: the controller raises with its
    traceback, and no rank is left alive (the other one waited in a
    collective); the pool takes no more calls."""
    pool = launch.RankPool(MeshConfig(1, 2), device="cpu", timeout=TIMEOUT)
    procs = list(pool.procs)
    assert pool.call(launch.pool_pids) == procs[0].pid
    with pytest.raises(RuntimeError, match="fails on purpose"):
        pool.call(launch.fail_on_rank, 1)
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="ended"):
        pool.call(launch.pool_pids)


def test_dryrun_multichip_8():
    """``dryrun_multichip(8)``: a (2, 4) mesh of 8 ranks, one sharded
    prefill and decode and one explicit-TP decode on tiny shapes."""
    res = launch.dryrun_multichip(8, device="cpu", timeout=TIMEOUT)
    assert len(res) == 8
    assert all(r["mesh"] == (2, 4) and r["decode"] == (4, 256 * 4) for r in res)
    assert all(r["prefill"] == (4, 8, 256 * 4) and r["tp_decode"] == r["decode"] for r in res)


# ---------------------------------------------------------------- EngineConfig


C260 = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2,
                   vocab_size=260, seq_len=64)  # the byte tokenizer's 259 tokens and one merge


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ckpt")
    write_checkpoint(d / "model.bin", make_random_weights(C260, seed=31))
    ttok.make_byte_tokenizer([("ab", -1.0)]).save(d / "tokenizer.bin")
    return d


def _config(d, **kw):
    return EngineConfig(checkpoint=str(d / "model.bin"), tokenizer=str(d / "tokenizer.bin"),
                        max_batch=2, device="cpu", **kw)


@pytest.mark.parametrize("kw,want", [
    (dict(quant="w8a8", mesh_model=2), True),
    (dict(quant="w8a8", mesh_model=1), False),
    (dict(quant=None, mesh_model=2), False),
    (dict(quant="int8", mesh_model=2), False),
    (dict(quant="w8a8", mesh_model=2, mesh_data=2), False),
    (dict(quant="w8a8", mesh_model=2, fuse=False), False),
    (dict(quant="w8a8", mesh_model=2, kv_layout="paged"), False),
    (dict(quant="w8a8", mesh_model=4), False),  # 256 % (128 x 4)
])
def test_tp_fused_rule_is_jax(ckpt, kw, want):
    """``tp_fused_rule`` is JAX's (engine_config.py:84-91), case by case."""
    cfg = _config(ckpt, kv_dtype="int8", **kw)
    assert cfg.tp_fused_rule(C260) is want
    jcfg = JaxEngineConfig(**{k: v for k, v in vars(cfg).items() if k != "device"})
    j = (jcfg.fuse and jcfg.mesh_model > 1 and jcfg.mesh_data == 1 and jcfg.quant == "w8a8"
         and jcfg.kv_layout == "dense" and C260.dim % (128 * jcfg.mesh_model) == 0)
    assert j is want


def _greedy(eng, tok, text="ab ab", steps=12):
    b = ContinuousBatcher(eng)
    r = Request(prompt_tokens=tok.encode(text), steps=steps, temperature=0.0)
    b.submit(r)
    b.run()
    return r.out_tokens


@pytest.mark.parametrize("quant,tp_fused", [("w8a8", True), (None, False)])
def test_build_engine_with_mesh(ckpt, tmp_path, quant, tp_fused):
    """``EngineConfig`` saved with a mesh of (1, 2) and loaded builds a
    controller of the engine JAX's rule names, which serves: the sharded
    engine's greedy stream equals the unsharded engine's on the same
    checkpoint; the ``tp_fused`` engine's equals the explicit-TP engine's
    run on its ranks."""
    path = tmp_path / "engine.json"
    _config(ckpt, quant=quant, kv_dtype="int8", mesh_model=2, precision="highest").save(path)
    assert json.loads(path.read_text())["mesh"] == {"data": 1, "model": 2}
    eng, tok = EngineConfig.load(path).build_engine()
    try:
        assert isinstance(eng, launch.MeshEngine)
        assert eng.tp_fused is tp_fused and eng.spmd is not tp_fused
        got = _greedy(eng, tok)
    finally:
        eng.close()
    assert got
    if not tp_fused:
        single, tok1 = _config(ckpt, quant=quant, kv_dtype="int8",
                               precision="highest").build_engine()
        assert got == _greedy(single, tok1)


def test_serve_cli_config_with_mesh(ckpt, tmp_path):
    """``python -m tpu_llama_torch.runtime.server --config`` with a (1, 2)
    mesh serves /generate with the unsharded engine's greedy text, and
    exits cleanly when interrupted (its ranks, daemon processes, end with
    it)."""
    path = tmp_path / "serve.json"
    cfg = _config(ckpt, kv_dtype="float32", mesh_model=2, precision="highest")
    cfg.server.port = 0
    cfg.save(path)
    payload = {"prompt": "ab ab", "steps": 16, "temperature": 0.0}
    proc = subprocess.Popen([sys.executable, "-m", "tpu_llama_torch.runtime.server", "--config",
                             str(path)], cwd=ROOT, stdout=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        line = ""
        while "serving on :" not in line:
            line = proc.stdout.readline()
            assert line, "the server exited before it listened"
        got = _post_generate(int(line.split("serving on :")[1].split()[0]), payload)
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    single, tok = _config(ckpt, kv_dtype="float32", precision="highest").build_engine()
    assert got["tokens"] == _server_generate(single, tok, payload)["tokens"]


def test_paged_cache_under_a_mesh_names_roadmap():
    """No JAX test holds a paged cache under a mesh: it stays refused."""
    from tpu_llama_torch.parallel.sharding import shard_params_spmd
    from tpu_llama_torch.parallel.mesh import Mesh

    mesh = Mesh(config=MeshConfig(1, 1), rank=0, data_index=0, model_index=0,
                model_group=None, data_group=None, backend=None, device=torch.device("cpu"))
    params = shard_params_spmd(_params(), mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(params, TINY, mesh=mesh, kv_layout="paged")


def _mesh(dp: int, d: int):
    from tpu_llama_torch.parallel.mesh import Mesh

    return Mesh(config=MeshConfig(dp, 1), rank=d, data_index=d, model_index=0,
                model_group=None, data_group=None, backend=None, device=torch.device("cpu"))


@pytest.mark.parametrize("fused,max_batch", [("mega2", 8), ("mega2", 40), (True, 40)])
def test_model_1_takes_the_whole_batchs_fused_mode(fused, max_batch):
    """At model = 1 each data rank decodes with the fused mode that the
    single-device engine takes for the whole batch, not for its share of
    the slots: at dp = 2 with 40 slots (20 a rank), the fused modes that
    hold at most MAX_ROWS (32) slots are refused, as on one device, and at
    8 slots both take the mode asked for."""
    from tpu_llama_torch.parallel.sharding import shard_params_spmd

    params = tl.random_quant_params(TINY, seed=SEED, fuse=True, device="cpu")
    kw = dict(max_batch=max_batch, kv_dtype="int8", attn="flash", fused=fused)
    if max_batch > 32:
        for d in range(2):
            with pytest.raises(ValueError, match="slots"):
                Engine(shard_params_spmd(params, _mesh(2, d)), TINY, mesh=_mesh(2, d), **kw)
        with pytest.raises(ValueError, match="slots"):
            Engine(params, TINY, device="cpu", **kw)
        return
    single = Engine(params, TINY, device="cpu", **kw)
    ranks = [Engine(shard_params_spmd(params, _mesh(2, d)), TINY, mesh=_mesh(2, d), **kw)
             for d in range(2)]
    assert all(r.decode_fused == single.decode_fused == fused for r in ranks)
    assert all(r.slots_per_rank == max_batch // 2 for r in ranks)

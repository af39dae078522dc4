"""Port parity of the explicit tensor-parallel paths (``tpu_llama_torch.
parallel``) against the JAX package's (``tpu_llama.parallel``), the
contracts of tests/test_tp.py and tests/test_tp_engine.py.

The port's ranks are processes started with ``torch.multiprocessing``'s
spawn method on the CPU, joined over gloo (``parallel.launch.run``); their
entry points live in the port (``parallel.launch``), so the children import
torch and the port only.  Each (dp, tp) mesh is one run of several entry
points, shared by the tests of this file.  The JAX side runs here, on
tests/conftest.py's 8 virtual CPU devices; both sides build their weights
from the same numpy seed (``make_random_weights``).

Limits, and why.

* f32 weights and caches (``precision="highest"``): the port's TP decode
  and prefill against JAX's on the same mesh shape and against the port's
  single-device paths, 1e-5 (JAX's own TP-against-single-device limit):
  only the order of f32 sums differs.
* INT8 KV: 1e-4, JAX's limit for the same comparison.
* Q8_0 weights: K25's plain version rounds its activation rows to bf16, so
  f32 values a few ulps apart upstream can flip a rounding (the known
  property of tests/test_torch_dense_model.py): 1e-2 of max |logit| and
  the same greedy tokens.
* W8A8 shards and the fused kernel path: XLA contracts FMAs and
  approximates rsqrt and exp inside the interpreted Pallas kernels (K3, K4,
  K11's property; tests/test_torch_tp_kernels.py), which can move one int8
  of a row quant by one step: 1e-3 of max |logit| against JAX's same path
  and the same greedy tokens; against the port's own unfused TP decode,
  JAX's limits (2e-2, 8e-2 with INT8 KV) and the same greedy tokens.
* Serving: greedy streams token for token.
Every rank returns the same logits (they are all-gathered): checked
bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig as JConfig
from tpu_llama.io.checkpoint import make_random_weights as j_weights
from tpu_llama.models import make_kv_cache as j_cache
from tpu_llama.models import params_from_raw as j_params
from tpu_llama.models import quantize_params as j_quant
from tpu_llama.models.llama import fuse_projections as j_fuse
from tpu_llama.parallel import MeshConfig as JMesh
from tpu_llama.parallel import make_mesh as j_mesh
from tpu_llama.parallel import shard_cache as j_shard_cache
from tpu_llama.parallel import shard_params as j_shard
from tpu_llama.parallel.tp import tp_forward_decode as j_tp_decode
from tpu_llama.parallel.tp import tp_forward_decode_fused as j_tp_fused
from tpu_llama.parallel.tp import tp_forward_prefill as j_tp_prefill
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.io.checkpoint import make_random_weights
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.parallel import MeshConfig, launch, single_device_mesh
from tpu_llama_torch.parallel.mesh import Mesh
from tpu_llama_torch.parallel.sharding import shard_params
from tpu_llama_torch.runtime import Engine

torch.set_num_threads(1)

TIMEOUT = 120  # seconds a run of ranks may take before it fails the test
TINY = ModelConfig(dim=48, hidden_dim=128, n_layers=3, n_heads=4, n_kv_heads=4,
                   vocab_size=320, seq_len=64, shared_weights=True)  # tests/conftest.py
C256 = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=2, n_kv_heads=2,
                   vocab_size=256, seq_len=32)  # tests/test_tp.py
C256_64 = dataclasses.replace(C256, seq_len=64)  # tests/test_tp_engine.py
TINY_SEED = 1234
PROMPT = ((np.arange(16) % 250) + 1).reshape(2, 8)  # tests/test_tp.py's [B, T] prompts
SERVE_PROMPTS = ([5, 9, 13], [7, 2], [11, 3, 8, 4])
SERVE_STEPS = 10


def _jc(c: ModelConfig) -> JConfig:
    return JConfig(**dataclasses.asdict(c))


def _decode_calls(dp):
    B = 2 * dp
    return [("decode", launch.decode_roll,
             dict(config=TINY, seed=TINY_SEED, tokens=np.arange(B) + 5, steps=3,
                  precision="highest"))]


def _run(dp, tp, calls):
    return launch.run(launch.batch, MeshConfig(dp, tp), args=(calls,), backend="gloo",
                      device="cpu", timeout=TIMEOUT)


@pytest.fixture(scope="module")
def mesh12():
    """Every (1, 2) run of this file, in one start of two ranks."""
    toks = np.array([5, 9])
    roll = dict(tokens=toks, steps=3, feed="argmax")
    calls = _decode_calls(1) + [
        ("int8_kv", launch.decode_roll, dict(config=TINY, seed=TINY_SEED, tokens=toks, steps=1,
                                             kv="int8", precision="highest")),
        ("padded", launch.refused, dict(config=TINY, seed=TINY_SEED, quant="q8_0")),
        ("q8_0", launch.decode_roll, dict(config=C256, seed=3, tokens=toks, steps=1,
                                          quant="q8_0", group_size=16, precision="highest")),
        ("fp_fused", launch.decode_roll, dict(config=C256, seed=7, tokens=toks, steps=1,
                                              fuse=True, precision="highest")),
        ("w8a8_unfused", launch.decode_roll, dict(config=C256, seed=7, tokens=toks, steps=1,
                                                  quant="w8a8", precision="highest")),
        ("w8a8_fused", launch.decode_roll, dict(config=C256, seed=7, tokens=toks, steps=1,
                                                fuse=True, quant="w8a8", precision="highest")),
        ("prefill", launch.prefill_case, dict(config=C256, seed=13, tokens=PROMPT,
                                              lengths=[8, 5], precision="highest")),
        ("prefill_fused", launch.prefill_case, dict(config=C256, seed=13, tokens=PROMPT,
                                                    lengths=[8, 5], fuse=True,
                                                    precision="highest")),
        ("serve", launch.serve, dict(config=C256_64, seed=29, prompts=SERVE_PROMPTS,
                                     steps=SERVE_STEPS, max_batch=2)),
    ]
    for kv in (None, "int8"):
        w = dict(config=C256, seed=11, fuse=True, quant="w8a8", kv=kv, **roll)
        calls += [(f"unfused_{kv}", launch.decode_roll, dict(w, precision="highest")),
                  (f"fused_{kv}", launch.decode_roll, dict(w, fused_kernels=True))]
    trip = dict(config=C256, seed=17, tokens=toks, steps=3, feed="argmax", fuse=True,
                quant="w8a8", kv="int8", prompt=PROMPT)
    calls += [("trip_unfused", launch.decode_roll, dict(trip, precision="default")),
              ("trip_fused", launch.decode_roll, dict(trip, fused_kernels=True))]
    return _run(1, 2, calls)


@pytest.fixture(scope="module")
def mesh14():
    toks = np.array([5, 9])
    calls = _decode_calls(1) + [
        (f"overlap_{o}", launch.decode_roll,
         dict(config=TINY, seed=TINY_SEED, tokens=toks, steps=3, feed="argmax",
              precision="highest", overlap=o)) for o in (False, True)]
    return _run(1, 4, calls)


@pytest.fixture(scope="module")
def mesh22():
    return _run(2, 2, _decode_calls(2))


def _same_on_every_rank(runs, key):
    for r in runs[1:]:
        for a, b in zip(r[key]["logits"], runs[0][key]["logits"]):
            np.testing.assert_array_equal(a, b)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _near_peak(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _jax_tp(dp, tp, params, fn, tokens, steps, kv=None, feed="step", config=None, prompt=None,
            **kw):
    """JAX's roll of ``fn`` on a (dp, tp) mesh, as launch.decode_roll rolls
    the port's."""
    c = _jc(config)
    mesh = j_mesh(JMesh(dp, tp))
    sp = j_shard(params, mesh)
    sc = j_shard_cache(j_cache(c, len(tokens), kv), mesh)
    B = len(tokens)
    toks = jnp.asarray(tokens, jnp.int32)
    t, start, out = toks, jnp.zeros(B, jnp.int32), {"logits": [], "tokens": []}
    if prompt is not None:
        start = jnp.full((B,), prompt.shape[1], jnp.int32)
        logits, sc = j_tp_prefill(sp, sc, jnp.asarray(prompt, jnp.int32), jnp.zeros(B, jnp.int32),
                                  start, c, mesh, logits_mode="last")
        t = jnp.argmax(logits, -1).astype(jnp.int32)
        out["tokens"].append(np.asarray(t))
    for p in range(steps):
        logits, sc = fn(sp, sc, toks + p if feed == "step" else t, start + p, c, mesh, **kw)
        t = jnp.argmax(logits, -1).astype(jnp.int32)
        out["logits"].append(np.asarray(logits))
        out["tokens"].append(np.asarray(t))
    return out


# ---------------------------------------------------------------- sharding


def test_shard_params_equals_jax_shards(tiny_weights):
    """Each rank's shard of every leaf (dense tiny weights, and W8A8 in the
    tp-interleaved fused layouts) is JAX's device shard for that model
    index, byte for byte (the port's quantized weights are K-major)."""
    dense = tl.params_from_raw(make_random_weights(C256, seed=5), device="cpu")
    jdense = j_params(j_weights(_jc(C256), seed=5))
    pairs = [(tl.quantize_params(tl.fuse_projections(dense, tp=2), mode="w8a8"),
              j_quant(j_fuse(jdense, tp=2), mode="w8a8"))]
    pairs.append((tl.params_from_raw(make_random_weights(TINY, seed=TINY_SEED), device="cpu"),
                  j_params(tiny_weights)))
    jmesh = j_mesh(JMesh(1, 2))
    for port, jax_p in pairs:
        jsp = j_shard(jax_p, jmesh)
        for idx in range(2):
            mesh = Mesh(config=MeshConfig(1, 2), rank=idx, data_index=0, model_index=idx,
                        model_group=None, data_group=None, backend=None,
                        device=torch.device("cpu"))
            mine = shard_params(port, mesh)
            for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
                got, want = getattr(mine.layers, name), getattr(jsp.layers, name)
                if hasattr(want, "q"):  # per-channel W8A8 (no padding at these widths)
                    wq, ws = (np.asarray(a.addressable_shards[idx].data) for a in (want.q, want.s))
                    np.testing.assert_array_equal(got.q.numpy(), np.swapaxes(wq, -1, -2))
                    np.testing.assert_array_equal(got.s.numpy(), ws)
                else:
                    np.testing.assert_array_equal(
                        got.numpy(), np.asarray(want.addressable_shards[idx].data))
            np.testing.assert_array_equal(
                mine.tok_emb.numpy(), np.asarray(jsp.tok_emb.addressable_shards[idx].data))


def test_tp_interleave_equals_fusing_with_tp():
    """``tp_interleave`` of W8A8 fused tp = 1 layouts (as
    random_quant_params(fuse=True) draws them) equals quantizing
    fuse_projections(tp)'s weights byte for byte: the per-channel quant
    sees each column alone.  (fuse_projections(tp) is tp_interleave of the
    tp = 1 fusion; test_torch_model.py holds it to JAX's order.)"""
    dense = tl.params_from_raw(make_random_weights(C256, seed=3), device="cpu")
    for tp in (1, 2):
        want = tl.fuse_projections(dense, tp=tp)
        got = tl.tp_interleave(tl.fuse_projections(dense), C256, tp)
        assert torch.equal(got.layers.wq, want.layers.wq)
        assert torch.equal(got.layers.w1, want.layers.w1)
        qwant = tl.quantize_params(want, mode="w8a8")
        qgot = tl.tp_interleave(tl.quantize_params(tl.fuse_projections(dense), mode="w8a8"),
                                C256, tp)
        for name in ("wq", "w1"):
            a, b = getattr(qgot.layers, name), getattr(qwant.layers, name)
            assert torch.equal(a.q, b.q) and torch.equal(a.s, b.s)


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("dp,tp", [(1, 2), (1, 4), (2, 2)])
def test_tp_decode_matches_jax_and_single_device(tiny_weights, dp, tp, request):
    runs = request.getfixturevalue(f"mesh{dp}{tp}")
    _same_on_every_rank(runs, "decode")
    got = runs[0]["decode"]["logits"]
    B = 2 * dp
    want = _jax_tp(dp, tp, j_params(tiny_weights), j_tp_decode, np.arange(B) + 5, 3,
                   config=TINY, precision="highest")["logits"]
    params = tl.params_from_raw(make_random_weights(TINY, seed=TINY_SEED), device="cpu")
    cache = tl.make_kv_cache(TINY, B, device="cpu")
    for p in range(3):
        single, cache = tl.forward_decode(params, cache, torch.arange(B) + 5 + p,
                                          torch.full((B,), p), TINY, precision="highest")
        _close(got[p], want[p], 1e-5)
        _close(got[p], single.numpy(), 1e-5)


def test_tp_decode_int8_kv(tiny_weights, mesh12):
    got = mesh12[0]["int8_kv"]
    want = _jax_tp(1, 2, j_params(tiny_weights), j_tp_decode, [5, 9], 1, kv="int8",
                   config=TINY, precision="highest")
    _close(got["logits"][0], want["logits"][0], 1e-4)
    assert got["cache_k"].dtype == np.int8


def test_tp_rejects_padded_quant(tiny_weights, mesh12):
    """dim 48 pads its Q8_0 groups: JAX and the port both refuse."""
    assert "padding-free" in mesh12[0]["padded"] and "padding-free" in mesh12[1]["padded"]
    mesh = j_mesh(JMesh(1, 2))
    with pytest.raises(ValueError, match="padding-free"):
        j_tp_decode(j_shard(j_quant(j_params(tiny_weights)), mesh),
                    j_shard_cache(j_cache(_jc(TINY), 2), mesh), jnp.array([5, 9], jnp.int32),
                    jnp.zeros(2, jnp.int32), _jc(TINY), mesh)


def test_tp_decode_q8_0_weights(mesh12):
    got = mesh12[0]["q8_0"]["logits"][0]
    want = _jax_tp(1, 2, j_quant(j_params(j_weights(_jc(C256), seed=3)), group_size=16),
                   j_tp_decode, [5, 9], 1, config=C256, precision="highest")["logits"][0]
    _near_peak(got, want, 1e-2)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_tp_overlap_matches_allreduce(tiny_weights, mesh14):
    """The ring collective matmul equals the all-reduce form, and JAX's
    overlapped roll."""
    _same_on_every_rank(mesh14, "overlap_True")
    plain, ring = mesh14[0]["overlap_False"], mesh14[0]["overlap_True"]
    want = _jax_tp(1, 4, j_params(tiny_weights), j_tp_decode, [5, 9], 3, feed="argmax",
                   config=TINY, precision="highest", overlap=True)
    for a, b, w in zip(plain["logits"], ring["logits"], want["logits"]):
        _close(b, a, 1e-5)
        _close(b, w, 1e-5)


@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_tp_decode_fused_projections(mesh12, quant):
    """fuse_projections(tp=2)'s shard-interleaved qkv / w13 through the
    unfused TP decode: against JAX's same path, and against the port's
    single-device decode (f32) or its unfused-layout TP decode (W8A8, whose
    per-shard activation quant differs from single-device by design)."""
    jw = j_params(j_weights(_jc(C256), seed=7))
    jfused = j_fuse(jw, tp=2)
    if quant is None:
        got = mesh12[0]["fp_fused"]["logits"][0]
        dense = tl.params_from_raw(make_random_weights(C256, seed=7), device="cpu")
        ref, _ = tl.forward_decode(dense, tl.make_kv_cache(C256, 2, device="cpu"),
                                   torch.tensor([5, 9]), torch.zeros(2), C256,
                                   precision="highest")
        ref, tol = ref.numpy(), 1e-5
    else:
        got = mesh12[0]["w8a8_fused"]["logits"][0]
        jfused = j_quant(jfused, mode=quant)
        ref, tol = mesh12[0]["w8a8_unfused"]["logits"][0], 1e-5
    want = _jax_tp(1, 2, jfused, j_tp_decode, [5, 9], 1, config=C256,
                   precision="highest")["logits"][0]
    _close(got, ref, tol)
    _near_peak(got, want, 1e-5 if quant is None else 1e-3)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("kv", [None, "int8"])
def test_tp_fused_kernel_path_matches_unfused(mesh12, kv):
    """tp_forward_decode_fused (K8, K9 / K19, K2, K23, K24, K10) against the
    port's unfused TP decode and against JAX's fused TP decode."""
    _same_on_every_rank(mesh12, f"fused_{kv}")
    ref, got = mesh12[0][f"unfused_{kv}"], mesh12[0][f"fused_{kv}"]
    jp = j_quant(j_fuse(j_params(j_weights(_jc(C256), seed=11)), tp=2), mode="w8a8")
    want = _jax_tp(1, 2, jp, j_tp_fused, [5, 9], 3, kv=kv, feed="argmax", config=C256)
    tol = 2e-2 if kv is None else 8e-2
    for r, g, w in zip(ref["logits"], got["logits"], want["logits"]):
        _close(g, r, tol)
        np.testing.assert_array_equal(g.argmax(-1), r.argmax(-1))
        _near_peak(g, w, 1e-3)
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


# ----------------------------------------------------------------- prefill


@pytest.mark.parametrize("fused_tp", [False, True])
def test_tp_prefill_matches_jax_and_single_device(mesh12, fused_tp):
    """tp_forward_prefill (f32, lengths 8 and 5) against JAX's and the
    port's single-device prefill, logits and every rank's cache rows."""
    key = "prefill_fused" if fused_tp else "prefill"
    got = mesh12[0][key]
    np.testing.assert_array_equal(mesh12[1][key]["logits"], got["logits"])
    lengths = np.array([8, 5])
    dense = tl.params_from_raw(make_random_weights(C256, seed=13), device="cpu")
    ref, ref_cache = tl.forward_prefill(dense, tl.make_kv_cache(C256, 2, device="cpu"),
                                        torch.tensor(PROMPT), torch.zeros(2, dtype=torch.long),
                                        torch.tensor(lengths), C256, logits_mode="last",
                                        precision="highest")
    jp = j_params(j_weights(_jc(C256), seed=13))
    mesh = j_mesh(JMesh(1, 2))
    want, _ = j_tp_prefill(j_shard(j_fuse(jp, tp=2) if fused_tp else jp, mesh),
                           j_shard_cache(j_cache(_jc(C256), 2), mesh),
                           jnp.asarray(PROMPT, jnp.int32), jnp.zeros(2, jnp.int32),
                           jnp.asarray(lengths, jnp.int32), _jc(C256), mesh,
                           precision="highest", logits_mode="last")
    _close(got["logits"], np.asarray(want), 1e-5)
    _close(got["logits"], ref.numpy(), 1e-5)
    local = np.concatenate([r[key]["cache_k"] for r in mesh12], axis=2)  # the kv heads
    # rows a prompt wrote (JAX also writes its padding rows at 5..7)
    for b, n in enumerate(lengths):
        _close(local[:, b, :, :n], ref_cache.k.numpy()[:, b, :, :n], 1e-5)


def test_tp_prefill_then_fused_decode_roundtrip(mesh12):
    """The serving shape: TP prefill fills the INT8 cache, then the fused TP
    decode continues: greedy tokens equal the unfused TP decode's and JAX's
    fused roll."""
    fused, unfused = mesh12[0]["trip_fused"]["tokens"], mesh12[0]["trip_unfused"]["tokens"]
    jp = j_quant(j_fuse(j_params(j_weights(_jc(C256), seed=17)), tp=2), mode="w8a8")
    want = _jax_tp(1, 2, jp, j_tp_fused, [5, 9], 3, kv="int8", feed="argmax", config=C256,
                   prompt=PROMPT)["tokens"]
    for f, u, w in zip(fused, unfused, want):
        np.testing.assert_array_equal(f, u)
        np.testing.assert_array_equal(f, w)


# ----------------------------------------------------------------- serving


def test_tp_engine_streams_equal_jax(mesh12):
    """Engine(mesh, tp_fused=True) + ContinuousBatcher on every rank (two
    slots for three requests: one joins in flight) against the JAX engine
    with the same batcher on a (1, 2) mesh: greedy streams token for token,
    on both ranks; rank 0 alone emits."""
    from tpu_llama.runtime import Engine as JEngine
    from tpu_llama.runtime.scheduler import ContinuousBatcher as JBatcher
    from tpu_llama.runtime.scheduler import Request as JRequest

    mesh = j_mesh(JMesh(1, 2))
    jp = j_quant(j_fuse(j_params(j_weights(_jc(C256_64), seed=29)), tp=2), mode="w8a8")
    eng = JEngine(j_shard(jp, mesh), _jc(C256_64), max_batch=2, kv_dtype="int8", mesh=mesh,
                  tp_fused=True)
    batcher = JBatcher(eng)
    reqs = [JRequest(prompt_tokens=list(p), steps=SERVE_STEPS, temperature=0.0)
            for p in SERVE_PROMPTS]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    want = [r.out_tokens for r in reqs]
    assert all(want)
    for rank in mesh12:
        assert rank["serve"]["streams"] == want
    emitted = mesh12[0]["serve"]["emitted"]
    assert [[t for i, t in emitted if i == k] for k in range(len(want))] == want
    assert mesh12[1]["serve"]["emitted"] == []


def test_tp_engine_prefix_cache_turns_off():
    """The TP engine under a prefix cache (C256 W8A8, prefix_cache_size 4):
    a prompt, then one that extends it.  The cache no longer turns off:
    snapshot_slot copies the local shard, the second request is a hit
    continued through ``tp_forward_prefill`` at start_pos > 0, as JAX's
    engine continues it, and both streams equal a cold engine's."""
    from tpu_llama_torch.runtime import ContinuousBatcher, Request

    mesh = single_device_mesh("cpu")
    params = launch.tp_params(mesh, C256, 31, fuse=True, quant="w8a8")

    def serve(prefix_cache_size):
        eng = Engine(params, C256, max_batch=2, kv_dtype="int8", mesh=mesh, tp_fused=True)
        batcher = ContinuousBatcher(eng, prefix_cache_size=prefix_cache_size)
        reqs = []
        for prompt in ([5, 9, 13, 7], [5, 9, 13, 7, 11, 3]):
            reqs.append(Request(prompt_tokens=prompt, steps=len(prompt) + 5, temperature=0.0))
            batcher.submit(reqs[-1])
            batcher.run()
        assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
        return batcher, [r.out_tokens for r in reqs]

    eng = Engine(params, C256, max_batch=2, kv_dtype="int8", mesh=mesh, tp_fused=True)
    assert eng.snapshot_slot(0, 3)["length"] == 3
    hot, streams = serve(4)
    assert hot.prefix_cache_size == 4 and hot.prefix_hits == 1
    assert streams == serve(0)[1]


def test_tp_engine_refusals():
    cfg = C256
    params = tl.params_from_raw(make_random_weights(cfg, seed=1), device="cpu")
    mesh = single_device_mesh("cpu")  # one process: a (1, 1) mesh, no process group
    with pytest.raises(ValueError, match="requires a mesh"):
        Engine(params, cfg, device="cpu", tp_fused=True)
    with pytest.raises(ValueError, match="paged"):
        Engine(params, cfg, mesh=mesh, tp_fused=True, kv_layout="paged")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(params, cfg, mesh=mesh, kv_layout="paged")
    dp2 = dataclasses.replace(mesh, config=MeshConfig(2, 1))
    with pytest.raises(ValueError, match="dp=1-only"):
        Engine(params, cfg, mesh=dp2, tp_fused=True)
    eng = Engine(params, cfg, max_batch=2, kv_dtype="int8", mesh=mesh, tp_fused=True)
    assert eng.cache.k.shape == (2, 2, 2, 32, 128) and eng.decode_fused == "tp"
    with pytest.raises(ValueError, match="W8A8"):
        eng.decode(np.array([1, 2]), np.array([0, 0]))
    assert eng.prefill_continue([[3, 4]], [0], [5]).shape == (1, cfg.vocab_size)

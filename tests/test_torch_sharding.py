"""The port's sharded engine (``tpu_llama_torch.parallel.spmd``: JAX's GSPMD
single program as explicit SPMD) against the port's single-device forward
and against the JAX package's sharded and single-device forwards: the
contracts of tests/test_sharding.py and tests/test_sharding_int8.py.

The port's ranks are processes started with ``torch.multiprocessing``'s
spawn method on the CPU, joined over gloo (``parallel.launch.run``); each
(dp, tp) mesh is one run of several entry points (``launch.batch``),
shared by the tests of this file.  The JAX side runs here, on
tests/conftest.py's 8 virtual CPU devices.  Every side builds its weights
from the same numpy seed (``make_random_weights``).

Limits, and why.

* Against the port's single-device forward, the JAX tests' own limits for
  sharded against single-device: rtol 1e-5 / atol 1e-6 for f32 weights and
  caches and for Q8_0 weights, 1e-4 / 1e-5 with an INT8 cache; only the
  order of f32 sums differs (a row-sharded product sums f32 partials
  across ranks; a rank's products see its own rows).
* W8A8 weights: bit for bit.  Each column product quantizes the whole row
  (K2) and sums exactly in int32; each row-sharded product's int32 sums are
  all-reduced, exactly, before K1's epilogue runs once.
* Q8_0 over several steps: K25 rounds every activation it multiplies to
  bf16 (matmul.py:133), so a residual stream a few f32 ulps from the single
  device's (the row-sharded w2's f32 partials) can land on the other side
  of a bf16 rounding: that input moves by 2^-8 of itself.  A 3-step roll
  is held to 1e-2 of max |logit| and equal greedy tokens, the port's Q8_0
  limit against JAX (tests/test_torch_dense_model.py); one step (the JAX
  test's case) to rtol 1e-5 / atol 1e-6.
* A bf16 cache: K and V round to bf16 from f32 values a few ulps apart,
  which can flip one rounding: 1e-3 of max |logit| (the port's bf16-cache
  limit against JAX).
* Against JAX (sharded and single-device), the port's limits against the
  JAX package (of max |logit|): 1e-5 for f32 weights and caches, 1e-4 with
  an INT8 cache and for W8A8 (tests/test_torch_model.py), 1e-2 for Q8_0.
* Each rank's cache shard equals the matching slice of the single-device
  cache: bit for bit for W8A8; within the logits' limits for f32 weights.
Every rank returns the same logits (they are all-gathered): bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig as JConfig
from tpu_llama.io.checkpoint import make_random_weights as j_weights
from tpu_llama.models import forward_decode as j_decode
from tpu_llama.models import forward_prefill as j_prefill
from tpu_llama.models import make_kv_cache as j_cache
from tpu_llama.models import params_from_raw as j_params
from tpu_llama.models import quantize_params as j_quant
from tpu_llama.parallel import MeshConfig as JMesh
from tpu_llama.parallel import make_mesh as j_mesh
from tpu_llama.parallel import shard_cache as j_shard_cache
from tpu_llama.parallel import shard_params as j_shard
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.io.checkpoint import make_random_weights
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import matmul as tm
from tpu_llama_torch.ops import quant as tq
from tpu_llama_torch.parallel import MeshConfig, launch
from tpu_llama_torch.parallel.mesh import Mesh
from tpu_llama_torch.parallel.sharding import shard_params_spmd

torch.set_num_threads(1)

TIMEOUT = 240  # seconds a run of ranks may take before it fails the test
TINY = ModelConfig(dim=48, hidden_dim=128, n_layers=3, n_heads=4, n_kv_heads=4,
                   vocab_size=320, seq_len=64, shared_weights=True)  # tests/conftest.py
SEED = 1234  # conftest's tiny_weights
TOKS = np.array([5, 9])  # tests/test_sharding.py's
PROMPT = np.array([[1, 5, 17, 300], [9, 250, 33, 2]])  # test_sharded_prefill_matches's
SUFFIX = np.array([[7, 8, 9], [11, 12, 0]])
SUFFIX_LENGTHS = [3, 2]
CHUNKED = np.random.default_rng(3).integers(3, 320, (2, 32))  # two chunks of 16
CHUNKED_LENGTHS = [32, 21]
MESHES = [(1, 2), (2, 1), (2, 4), (1, 4)]  # test_sharded_decode_matches_single_device's
ROLL_MESHES = [(1, 2), (2, 2), (1, 4)]
TOL = {"float32": (1e-5, 1e-6), "int8": (1e-4, 1e-5)}  # rtol, atol (the JAX tests')
JAX_TOL = {None: 1e-5, "int8": 1e-4, "w8a8": 1e-4, "q8_0": 1e-2}  # of max |logit|


def _jc(c: ModelConfig) -> JConfig:
    return JConfig(**dataclasses.asdict(c))


def _roll(quant=None, kv=None, steps=3):
    return dict(config=TINY, seed=SEED, tokens=TOKS, steps=steps, kv=kv, quant=quant,
                precision="highest")


def _calls(dp, tp):
    calls = [("dense", launch.spmd_decode_roll, _roll())]
    if (dp, tp) == (2, 4):
        calls.append(("prefill", launch.spmd_prefill_case,
                      dict(config=TINY, seed=SEED, tokens=PROMPT, lengths=[4, 4],
                           suffix=SUFFIX, suffix_lengths=SUFFIX_LENGTHS, precision="highest")))
    if (dp, tp) == (2, 2):  # tests/test_sharding_int8.py's three cases, one step each
        calls += [("q8_0_1", launch.spmd_decode_roll, _roll("q8_0", steps=1)),
                  ("int8_kv_1", launch.spmd_decode_roll, _roll(kv="int8", steps=1)),
                  ("w8a8_1", launch.spmd_decode_roll, _roll("w8a8", steps=1)),
                  ("q8_0", launch.spmd_decode_roll, _roll("q8_0"))]
    if (dp, tp) in ROLL_MESHES:
        calls += [(f"w8a8_{kv}", launch.spmd_decode_roll, _roll("w8a8", kv))
                  for kv in ("float32", "int8", "bfloat16")]
        calls.append(("w8a8_prefill", launch.spmd_prefill_case,
                      dict(config=TINY, seed=SEED, tokens=PROMPT, lengths=[4, 3], kv="int8",
                           quant="w8a8", suffix=SUFFIX, suffix_lengths=SUFFIX_LENGTHS)))
    if (dp, tp) == (1, 2):
        calls.append(("bf16_kv", launch.spmd_decode_roll, _roll(kv="bfloat16")))
        calls.append(("w8a8_chunked", launch.spmd_chunked_case,
                      dict(config=TINY, seed=SEED, tokens=CHUNKED, lengths=CHUNKED_LENGTHS,
                           chunk=16, kv="int8", quant="w8a8")))
    return calls


@pytest.fixture(scope="module")
def runs():
    """Every mesh's ranks, one run each, started on first use."""
    cache = {}

    def get(dp, tp):
        if (dp, tp) not in cache:
            cache[dp, tp] = launch.run(launch.batch, MeshConfig(dp, tp),
                                       args=(_calls(dp, tp),), backend="gloo", device="cpu",
                                       timeout=TIMEOUT)
        return cache[dp, tp]

    return get


# ---------------------------------------------------------------- references


def _port_params(quant=None):
    p = tl.params_from_raw(make_random_weights(TINY, seed=SEED), device="cpu")
    return p if quant is None else tl.quantize_params(p, mode=quant)


def _port_roll(quant=None, kv=None, steps=3):
    """The port's single-device forward_decode roll: logits and cache."""
    p = _port_params(quant)
    B = len(TOKS)
    c = tl.make_kv_cache(TINY, B, kv_dtype=kv or "float32", device="cpu")
    out = []
    for s in range(steps):
        lg, c = tl.forward_decode(p, c, torch.tensor(TOKS) + s, torch.full((B,), s), TINY,
                                  precision="highest")
        out.append(lg.numpy())
    return out, {n: getattr(c, n).float().numpy() for n in c.arrays}


def _port_prefill(quant=None, kv=None, lengths=(4, 4)):
    p = _port_params(quant)
    c = tl.make_kv_cache(TINY, 2, kv_dtype=kv or "float32", device="cpu")
    lg, c = tl.forward_prefill(p, c, torch.tensor(PROMPT), torch.zeros(2, dtype=torch.long),
                               torch.tensor(lengths), TINY, logits_mode="all",
                               precision="highest")
    cont, c = tl.forward_prefill(p, c, torch.tensor(SUFFIX), torch.full((2,), 4),
                                 torch.tensor(SUFFIX_LENGTHS), TINY, logits_mode="last",
                                 precision="highest")
    return lg.numpy(), cont.numpy(), {n: getattr(c, n).float().numpy() for n in c.arrays}


def _jax_roll(mesh_shape, quant=None, kv=None, steps=3):
    """JAX's forward_decode roll, sharded over ``mesh_shape`` (GSPMD) or on
    one device (None)."""
    c = _jc(TINY)
    p = j_params(j_weights(c, seed=SEED))
    if quant is not None:
        p = j_quant(p, mode=quant)
    cache = j_cache(c, len(TOKS), kv or "float32")
    if mesh_shape is not None:
        mesh = j_mesh(JMesh(*mesh_shape))
        p, cache = j_shard(p, mesh), j_shard_cache(cache, mesh)
    toks, out = jnp.asarray(TOKS, jnp.int32), []
    for s in range(steps):
        lg, cache = j_decode(p, cache, toks + s, jnp.full((len(TOKS),), s, jnp.int32), c)
        out.append(np.asarray(lg))
    return out


def _jax_prefill(mesh_shape):
    c = _jc(TINY)
    p = j_params(j_weights(c, seed=SEED))
    cache = j_cache(c, 2)
    if mesh_shape is not None:
        mesh = j_mesh(JMesh(*mesh_shape))
        p, cache = j_shard(p, mesh), j_shard_cache(cache, mesh)
    lg, _ = j_prefill(p, cache, jnp.asarray(PROMPT, jnp.int32), jnp.zeros(2, jnp.int32),
                      jnp.array([4, 4], jnp.int32), c)
    return np.asarray(lg)


# ---------------------------------------------------------------- checks


def _same_on_every_rank(ranks, key, field="logits"):
    for r in ranks[1:]:
        a, b = r[key][field], ranks[0][key][field]
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            np.testing.assert_array_equal(x, y)


def _close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _near_peak(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _shard(arr, dp, tp, d, m):
    """Rank (d, m)'s slice of a full cache array [L, B, KVH, ...]."""
    b, h = arr.shape[1] // dp, arr.shape[2] // tp
    return arr[:, d * b:(d + 1) * b, m * h:(m + 1) * h]


def _check_cache_shards(ranks, full, dp, tp, key, exact, tol=TOL["float32"]):
    for r, rank in enumerate(ranks):
        for n, want in full.items():
            got, want = rank[key]["cache"][n], _shard(want, dp, tp, r // tp, r % tp)
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                _close(got, want, *tol)


# ---------------------------------------------------------------- tests


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_decode_matches_single_device(runs, mesh_shape):
    """tests/test_sharding.py:25-54: three decode steps on dense f32 weights
    against the single-device forward (the port's at the JAX test's
    limit), JAX's single-device and JAX's sharded forward on the same mesh
    shape."""
    ranks = runs(*mesh_shape)
    got = ranks[0]["dense"]["logits"]
    want, _ = _port_roll()
    for g, w, js, jm in zip(got, want, _jax_roll(None), _jax_roll(mesh_shape)):
        _close(g, w, *TOL["float32"])
        _near_peak(g, js, JAX_TOL[None])
        _near_peak(g, jm, JAX_TOL[None])
    _same_on_every_rank(ranks, "dense")


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_decode_cache_shards(runs, mesh_shape):
    """Each rank holds its slots (over ``data``) and kv heads (over
    ``model``) of the single-device cache."""
    _, full = _port_roll()
    _check_cache_shards(runs(*mesh_shape), full, *mesh_shape, "dense", exact=False)


def test_sharded_prefill_matches(runs):
    """tests/test_sharding.py:57-72 at (2, 4): all-position prefill logits
    against the single-device forwards and JAX's sharded one, and a
    continuation at start_pos > 0 against the port's; the cache stays
    sharded (each rank's slice of the single device's)."""
    ranks = runs(2, 4)
    got = ranks[0]["prefill"]
    want, cont, full = _port_prefill()
    _close(got["prefill"], want, *TOL["float32"])
    _near_peak(got["prefill"], _jax_prefill(None), JAX_TOL[None])
    _near_peak(got["prefill"], _jax_prefill((2, 4)), JAX_TOL[None])
    _close(got["continued"], cont, *TOL["float32"])
    _same_on_every_rank(ranks, "prefill", "prefill")
    _same_on_every_rank(ranks, "prefill", "continued")
    _check_cache_shards(ranks, full, 2, 4, "prefill", exact=False)


@pytest.mark.parametrize("case,quant,kv", [("q8_0_1", "q8_0", None),
                                           ("int8_kv_1", None, "int8"),
                                           ("w8a8_1", "w8a8", None)])
def test_sharded_int8_decode(runs, case, quant, kv):
    """tests/test_sharding_int8.py's three cases at (2, 2), one decode step:
    Q8_0 weights and the INT8 cache at the JAX tests' limits against the
    port's single-device step, W8A8 bit for bit; each against JAX's sharded
    and single-device steps at the port's limits against JAX."""
    ranks = runs(2, 2)
    got = ranks[0][case]["logits"][0]
    want, full = _port_roll(quant, kv, steps=1)
    if quant == "w8a8":
        np.testing.assert_array_equal(got, want[0])
    else:
        _close(got, want[0], *TOL["int8" if kv == "int8" else "float32"])
    tol = JAX_TOL["int8" if kv == "int8" else quant]
    _near_peak(got, _jax_roll(None, quant, kv, steps=1)[0], tol)
    _near_peak(got, _jax_roll((2, 2), quant, kv, steps=1)[0], tol)
    _same_on_every_rank(ranks, case)
    _check_cache_shards(ranks, full, 2, 2, case, exact=quant == "w8a8",
                        tol=TOL["int8" if kv == "int8" else "float32"])


def test_sharded_q8_0_roll(runs):
    """Q8_0 over three steps at (2, 2): within the port's Q8_0 limit of the
    single-device roll (a bf16 rounding of K25's input may flip; module
    docstring) and the same greedy tokens; JAX's sharded roll at the same
    limit."""
    got = runs(2, 2)[0]["q8_0"]["logits"]
    want, _ = _port_roll("q8_0")
    for g, w, jm in zip(got, want, _jax_roll((2, 2), "q8_0")):
        _near_peak(g, w, JAX_TOL["q8_0"])
        _near_peak(g, jm, JAX_TOL["q8_0"])
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("kv", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("mesh_shape", ROLL_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_w8a8_roll_bit_equal(runs, mesh_shape, kv):
    """W8A8 over three steps on f32, INT8 and bf16 caches: the logits and
    every rank's cache shard bit for bit the single-device engine's (the
    int32 all-reduce of the row-sharded products; K2 on whole rows)."""
    ranks = runs(*mesh_shape)
    want, full = _port_roll("w8a8", kv)
    for g, w in zip(ranks[0][f"w8a8_{kv}"]["logits"], want):
        np.testing.assert_array_equal(g, w)
    _same_on_every_rank(ranks, f"w8a8_{kv}")
    _check_cache_shards(ranks, full, *mesh_shape, f"w8a8_{kv}", exact=True)
    if kv == "int8":
        for g, j in zip(ranks[0][f"w8a8_{kv}"]["logits"], _jax_roll(None, "w8a8", kv)):
            _near_peak(g, j, JAX_TOL["w8a8"])


@pytest.mark.parametrize("mesh_shape", ROLL_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_w8a8_prefill_and_continuation_bit_equal(runs, mesh_shape):
    """W8A8 over an INT8 cache: the all-position prefill of ragged prompts
    and a continuation at start_pos > 0, logits and cache shards bit for
    bit the single-device forward's."""
    ranks = runs(*mesh_shape)
    got = ranks[0]["w8a8_prefill"]
    want, cont, full = _port_prefill("w8a8", "int8", lengths=(4, 3))
    np.testing.assert_array_equal(got["prefill"], want)
    np.testing.assert_array_equal(got["continued"], cont)
    _check_cache_shards(ranks, full, *mesh_shape, "w8a8_prefill", exact=True)


def test_sharded_chunked_prefill_bit_equal(runs):
    """The sharded engine's long-prompt admission at (1, 2)
    (``spmd_prefill_chunked_rows``: each chunk through ``spmd_prefill_rows``
    at start i * chunk), W8A8 over an INT8 cache: the next-token logits and
    each rank's cache shard bit for bit the single-device
    ``forward_prefill_chunked``'s."""
    ranks = runs(1, 2)
    c = tl.make_kv_cache(TINY, 2, kv_dtype="int8", device="cpu")
    want, c = tl.forward_prefill_chunked(_port_params("w8a8"), c, torch.tensor(CHUNKED),
                                         torch.tensor(CHUNKED_LENGTHS), TINY, chunk=16)
    np.testing.assert_array_equal(ranks[0]["w8a8_chunked"]["logits"], want.numpy())
    _same_on_every_rank(ranks, "w8a8_chunked")
    _check_cache_shards(ranks, {n: getattr(c, n).float().numpy() for n in c.arrays}, 1, 2,
                        "w8a8_chunked", exact=True)


def test_sharded_bf16_cache(runs):
    """f32 weights over a bf16 cache at (1, 2): 1e-3 of max |logit| of the
    single-device roll (module docstring)."""
    want, _ = _port_roll(kv="bfloat16")
    for g, w in zip(runs(1, 2)[0]["bf16_kv"]["logits"], want):
        _near_peak(g, w, 1e-3)


# ---------------------------------------------------------------- shard rules


def _mesh_at(dp, tp, d, m):
    return Mesh(config=MeshConfig(dp, tp), rank=d * tp + m, data_index=d, model_index=m,
                model_group=None, data_group=None, backend=None, device=torch.device("cpu"))


def _dense_of(w):
    """A weight leaf as dense [.., in, out] f32 over its logical size."""
    if isinstance(w, tq.ChannelQuantTensor):
        return tq.dequantize_channel(w)
    if isinstance(w, tq.QuantTensor):
        return tq.dequantize(w)
    return w


@pytest.mark.parametrize("quant", [None, "q8_0", "w8a8"])
def test_param_sharding_layout(quant):
    """tests/test_sharding.py:75-83 and test_sharding_int8.py's layout check
    at model = 4: each rank's wq holds 1/4 of the heads' columns and w2 1/4
    of the hidden rows (a Q8_0 w2 whose cut would split a quant group is
    held whole); the shards concatenate to the whole weights."""
    full = _port_params(quant)
    shards = [shard_params_spmd(full, _mesh_at(1, 4, 0, m)) for m in range(4)]
    lp = full.layers
    for name, dim in (("wq", -1), ("wk", -1), ("w1", -1), ("w3", -1), ("wo", -2), ("w2", -2)):
        want = _dense_of(getattr(lp, name))
        parts = [_dense_of(getattr(s.layers, name)) for s in shards]
        if dim == -2 and parts[0].shape == want.shape:  # held whole
            assert isinstance(getattr(lp, name), tq.QuantTensor)
            g = getattr(lp, name).group_size
            assert (getattr(lp, name).logical_in // 4) % g
            for p in parts:
                torch.testing.assert_close(p, want, rtol=0, atol=0)
            continue
        assert parts[0].shape[dim] * 4 == want.shape[dim]
        torch.testing.assert_close(torch.cat(parts, dim=dim), want, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([s.tok_emb for s in shards]), full.tok_emb, rtol=0,
                               atol=0)
    torch.testing.assert_close(torch.cat([_dense_of(s.wcls) for s in shards], dim=-1),
                               _dense_of(full.wcls), rtol=0, atol=0)


def test_fused_layouts_shard_only_whole():
    """Fused layouts (wqkv, w13) are held whole at model = 1 and refused
    above it (their columns interleave q, k and v)."""
    fused = tl.fuse_projections(_port_params())
    whole = shard_params_spmd(fused, _mesh_at(2, 1, 1, 0))
    torch.testing.assert_close(whole.layers.wq, fused.layers.wq, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unfused layouts"):
        shard_params_spmd(fused, _mesh_at(1, 2, 0, 1))


def test_split_counts_read_the_whole_batch():
    """A rank that holds half the kv heads of Llama-2 7B at batch 8 would
    split K9's rows where the single device does not (B x KVH 128 < 132
    SMs): the sharded decode passes the whole batch's counts."""
    cache = tl.make_kv_cache(dataclasses.replace(TINY, n_kv_heads=16, n_heads=16, dim=16 * 128),
                             8, kv_dtype="int8", seq_len=2048, device="meta")
    whole, local = tl.split_counts(cache, 8, 32), tl.split_counts(cache, 8, 16)
    assert whole["flash_dma"] == 1 and local["flash_dma"] > 1
    assert whole["fused"] < local["fused"]


# ---------------------------------------------------------------- K1's int32 form


@pytest.mark.parametrize("m,k,n", [(8, 96, 40), (1, 48, 7), (17, 130, 33), (300, 64, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_k1_int32_slices_sum_to_k1(m, k, n, dtype, residual):
    """The plain version of K1's int32 form: the int32 sums of two K-slices,
    added and passed through ``w8a8_epilogue`` (with the residual),
    equal ``w8a8_matmul_prequant_plain`` on the whole K bit for bit."""
    g = torch.Generator().manual_seed(m * k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    sx = torch.rand(m, generator=g) * 0.1
    w = tq.ChannelQuantTensor(q=torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8),
                              s=torch.rand(n, generator=g) * 1e-3)
    r = (torch.randn(m, n, generator=g) * 4).to(dtype) if residual else None
    h = k // 2 + 1
    halves = [tq.ChannelQuantTensor(q=w.q[:, a:b].contiguous(), s=w.s)
              for a, b in ((0, h), (h, k))]
    acc = sum(tm.w8a8_matmul_int32(xq[:, a:b].contiguous(), hw)
              for (a, b), hw in zip(((0, h), (h, k)), halves))
    assert acc.dtype == torch.int32
    got = tm.w8a8_epilogue(acc, sx, w.s, dtype, r)
    want = tm.w8a8_matmul_prequant_plain(xq, sx, w, out_dtype=dtype, residual=r)
    assert torch.equal(got, want)
    torch.testing.assert_close(tm.w8a8_matmul_int32(xq, w),
                               tm.w8a8_matmul_int32_plain(xq, w), rtol=0, atol=0)

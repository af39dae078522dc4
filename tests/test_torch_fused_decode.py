"""Port parity of the fused decode: K8 ``w8a8_matmul_stacked``, K11
``fused_layer_linear`` and K12 ``fused_step2_layer`` (plain versions)
against the JAX package's Pallas kernels run in interpret mode, as its own
tests run them on the CPU; then ``greedy_decode_loop(fused=True)`` (the
two-launch decode) and ``fused="mega2"`` against the JAX package's.  Inputs
are made with numpy from a seed and handed to both packages; JAX gets its
32-row padding and its [L, in, out] weight layout, the port the real rows
and K-major weights.

Limits, and why.  XLA on the CPU contracts ``a * b + c`` into FMAs inside
the interpreted Pallas bodies (the residual adds of phases A and C, RoPE)
and computes rsqrt and exp with its own approximations; the port rounds
every product and sum, as the TPU kernels and the CUDA kernels do, and
takes K3's 1 / sqrt of an f64 sum of squares.  So:

* K8: bit-equal (two products per entry, no sum to contract).
* K11, K12 x_next and K11 qkv_next: within 2^-20 of max |value| (a few f32
  ulps of the largest entries; an int8 moved by one step anywhere upstream
  would show as ~1e-3).
* K12's int8 outputs (the fresh K/V rows and the quantized attention
  output): at most one step on at most 1% of entries (none move at these
  seeds); their scales within 2^-20 relative; the dequantized attention
  output within 2^-20 of its max.
* K12 against the port's own two-launch composition (K11, RoPE +
  quantize_kv, K9, K2): the JAX tests' limits (tests/test_fused_step2.py),
  since K12 rounds h2 and q to bf16 by design where the two-launch path
  keeps f32.
* Model level (TINY128 and the JAX tests' hd-128 config, f32 activations,
  after the same fused prefill): greedy tokens equal at every step; every
  step's logits within 1e-4 of max |logit| (the f32 noise above through
  the int8 quantizations); the flushed cache rows within one int8 step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_llama.models import llama as jl
from tpu_llama.ops import fused_layer as jfl
from tpu_llama.ops import fused_step2 as jfs
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import fused_layer as tfl
from tpu_llama_torch.ops import fused_step2 as tfs
from tpu_llama_torch.ops.quant import ChannelQuantTensor, quantize_activations

from test_torch_model import TINY128, _dequant, _prompts, build_fused_pair

torch.set_num_threads(1)

F32_REL = 2.0 ** -20
FLIP_SHARE = 1e-2
LOGITS_TOL = 1e-4
JAX_TINY = dict(dim=256, hidden_dim=256, n_layers=3, n_heads=2, n_kv_heads=2, vocab_size=64,
                seq_len=64, shared_weights=False)  # tests/test_fused_step2.py _tiny_config


def _stacked(rng, L, n_in, n_out):
    """Per-channel int8 weights: (q [L, in, out], s [L, out]), the JAX layout."""
    w = rng.standard_normal((L, n_in, n_out)).astype(np.float32) * 0.05
    s = (np.abs(w).max(1) / 127.0).astype(np.float32)
    return np.clip(np.rint(w / s[:, None, :]), -127, 127).astype(np.int8), s


def _port_w(q, s):
    return ChannelQuantTensor(q=torch.tensor(np.ascontiguousarray(np.swapaxes(q, -1, -2))),
                              s=torch.tensor(s))


def _case(seed, L, B, KVH, G, hd, H, S, pos):
    rng = np.random.default_rng(seed)
    D, KVD = KVH * G * hd, KVH * hd
    ang = rng.standard_normal((B, hd // 2)).astype(np.float32)
    return dict(
        L=L, B=B, D=D, H=H, KVH=KVH, G=G, hd=hd, S=S,
        w={k: _stacked(rng, L, *io) for k, io in
           (("wo", (D, D)), ("w13", (D, 2 * H)), ("w2", (H, D)), ("qkv", (D, D + 2 * KVD)))},
        rf=(1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32),
        ra=(1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32),
        x=rng.standard_normal((B, D)).astype(np.float32),
        attq=rng.integers(-127, 128, (B, D), dtype=np.int8),
        satt=(np.abs(rng.standard_normal(B)) * 0.01).astype(np.float32),
        kc=rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8),
        vc=rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8),
        ks=rng.uniform(0.005, 0.02, (L, B, KVH, S)).astype(np.float32),
        vs=rng.uniform(0.005, 0.02, (L, B, KVH, S)).astype(np.float32),
        cos=np.cos(ang).astype(np.float32), sin=np.sin(ang).astype(np.float32),
        pos=np.array(pos, np.int32))


def _pad(a, n=32):
    return jnp.asarray(np.pad(a, [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)))


def _jax_weights(c):
    return [jnp.asarray(a) for k in ("wo", "w13", "w2", "qkv") for a in c["w"][k]]


def _port_weights(c):
    return [_port_w(*c["w"][k]) for k in ("wo", "w13", "w2", "qkv")]


def _t(c, *names):
    return [torch.tensor(c[n]) for n in names]


def _near(got, want, rel=F32_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, peak = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * peak, (err, peak)


def _flips(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1 and (d != 0).mean() <= FLIP_SHARE, (d.max(), (d != 0).mean())


# --------------------------------------------------------------------- K8


def test_k8_equals_jax_every_layer():
    c = _case(1, L=3, B=5, KVH=1, G=1, hd=128, H=256, S=16, pos=[0] * 5)
    rng = np.random.default_rng(2)
    xq = rng.integers(-127, 128, (c["B"], c["D"]), dtype=np.int8)
    sx = rng.uniform(1e-3, 1e-1, c["B"]).astype(np.float32)
    q, s = c["w"]["qkv"]
    w = _port_w(q, s)
    _kernels.reset_counts()
    for layer in range(c["L"]):
        want = jfl.w8a8_matmul_stacked(_pad(xq), _pad(sx), jnp.asarray(q), jnp.asarray(s), layer)
        got = tfl.w8a8_matmul_stacked(torch.tensor(xq), torch.tensor(sx), w, layer)
        assert got.dtype == torch.float32 and got.shape == (c["B"], q.shape[2])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:c["B"]])
    assert _kernels.PLAIN_CALLS["K8"] == c["L"] and _kernels.PLAIN_CALLS["K1"] == 0


# -------------------------------------------------------------------- K11


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_k11_plain_matches_jax(layer):
    """The JAX test's shape (tests/test_fused_layer.py:56-70), 5 real rows."""
    c = _case(7, L=3, B=5, KVH=1, G=1, hd=128, H=256, S=16, pos=[0] * 5)
    jx, jqkv = jfl.fused_layer_linear(
        _pad(c["x"]), _pad(c["attq"]), _pad(c["satt"]), *_jax_weights(c),
        jnp.asarray(c["rf"]), jnp.asarray(c["ra"]), jnp.int32(layer), c["L"])
    sentinel = torch.full((c["B"], 384), 7.0)
    x, attq, satt, rf, ra = _t(c, "x", "attq", "satt", "rf", "ra")
    got_x, got_qkv = tfl.fused_layer_linear(x, attq, satt, *_port_weights(c), rf, ra, layer,
                                            c["L"], qkv_out=sentinel)
    assert got_qkv is sentinel
    _near(got_x.numpy(), np.asarray(jx)[:c["B"]])
    if layer + 1 < c["L"]:
        _near(got_qkv.numpy(), np.asarray(jqkv)[:c["B"]])
    else:  # the last layer computes no next qkv and leaves the buffer untouched
        assert (got_qkv == 7.0).all()


# -------------------------------------------------------------------- K12


def _jax_k12(c, layer):
    TS = jfs.step2_block_s(c["S"])
    base, dcell, doff, total = jfs.decode_dma_descs(jnp.asarray(c["pos"]), c["B"], c["S"], TS)
    rc, rsa, rsb = jfs.rope_tables(jnp.asarray(c["cos"]), jnp.asarray(c["sin"]), 32)
    out = jfs.fused_step2_layer(
        _pad(c["x"]), _pad(c["attq"]), _pad(c["satt"]), *(jnp.asarray(c[k]) for k in
                                                         ("kc", "vc", "ks", "vs", "pos")),
        rc, rsa, rsb, base, dcell, doff, total, *_jax_weights(c), jnp.asarray(c["rf"]),
        jnp.asarray(c["ra"]), jnp.int32(layer), c["L"], c["KVH"] * c["G"])
    return [np.asarray(o)[:c["B"]] for o in out]


def _port_k12(c, layer, fn=tfs.fused_step2_layer, **kw):
    out = fn(*_t(c, "x", "attq", "satt", "kc", "vc", "ks", "vs", "pos", "cos", "sin"),
             *_port_weights(c), *_t(c, "rf", "ra"), layer, c["L"], c["KVH"] * c["G"], **kw)
    return [o.numpy() for o in out]


K12_CASES = {"mha": (21, 1, 2, [0, 37, 63]), "gqa2": (22, 2, 1, [0, 7, 63])}


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("case", list(K12_CASES))
def test_k12_plain_matches_jax(case, layer):
    seed, G, KVH, pos = K12_CASES[case]
    c = _case(seed, L=3, B=3, KVH=KVH, G=G, hd=128, H=384, S=64, pos=pos)
    want = _jax_k12(c, layer)
    got = _port_k12(c, layer)
    _near(got[0], want[0])
    if layer + 1 == c["L"]:
        return  # the JAX kernel's other outputs are garbage there
    for i in (1, 3, 5):  # attq_next, kq, vq
        _flips(got[i], want[i])
    for i in (2, 4, 6):  # their scales
        np.testing.assert_allclose(got[i], want[i], rtol=F32_REL, atol=0)
    _near(got[1].astype(np.float32) * got[2][:, None],
          want[1].astype(np.float32) * want[2][:, None])


def _composed(c, layer, splits=None):
    """The port's two-launch layer: K11, then layer + 1's RoPE, quantize_kv,
    K9 (at ``splits``) and K2 (the contract of tests/test_fused_step2.py:74-99)."""
    x, attq, satt, rf, ra, cos, sin = _t(c, "x", "attq", "satt", "rf", "ra", "cos", "sin")
    x_next, qkv = tfl.fused_layer_linear(x, attq, satt, *_port_weights(c), rf, ra, layer,
                                         c["L"])
    cfg = ModelConfig(dim=c["D"], hidden_dim=c["H"], n_layers=c["L"],
                      n_heads=c["KVH"] * c["G"], n_kv_heads=c["KVH"], vocab_size=8,
                      seq_len=c["S"])
    q, (kq, ks), (vq, vs) = tl._split_qkv(qkv, cos, sin, cfg)
    att = tatt.flash_decode_attention_dma(q, *_t(c, "kc", "vc", "pos"), kq, vq,
                                          *_t(c, "ks", "vs"), ks, vs, layer=layer + 1,
                                          splits=splits)
    attq_n, satt_n = quantize_activations(att.reshape(c["B"], c["D"]))
    return [t.numpy() for t in (x_next, attq_n, satt_n, kq, ks, vq, vs)]


@pytest.mark.parametrize("case,layer", [("mha", 0), ("mha", 1), ("gqa2", 0)])
def test_k12_matches_two_launch_composition(case, layer):
    """The shapes of tests/test_fused_step2.py's two composition tests."""
    if case == "mha":
        c = _case(21, L=3, B=2, KVH=2, G=1, hd=128, H=384, S=64, pos=[5, 33])
    else:
        c = _case(22, L=2, B=3, KVH=1, G=2, hd=128, H=256, S=32, pos=[0, 7, 31])
    ref = _composed(c, layer)
    got = _port_k12(c, layer)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-2, atol=1e-2)
    for i in (3, 5):
        np.testing.assert_allclose(got[i], ref[i], atol=3)
    for i in (4, 6):
        np.testing.assert_allclose(got[i], ref[i], rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(got[1].astype(np.float32) * got[2][:, None],
                               ref[1].astype(np.float32) * ref[2][:, None], rtol=2e-2, atol=2e-2)


# K12's trailing cells split over the key rows (csrc/fused_step2.cuh, the
# split cell of K9): a cache of 512 rows in key blocks of 128, so 2 and 4
# splits each take whole blocks, and slots that end in the first, a middle
# and the last block.
SPLIT_CASE = dict(seed=23, L=3, B=3, KVH=2, G=1, hd=128, H=384, S=512, pos=[0, 300, 511])
SPLIT_TOL = 2.0 ** -8  # of max |out|: one bf16 step of a p rounded at a split's own max (K9)


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("layer", [0, 1])
def test_k12_plain_splits_match_jax(splits, layer):
    """At more than one split: x_next and the fresh K/V rows are the
    one-split plain version's exactly (the split touches only the cells),
    and within the JAX limits above; the attention output within 2^-8 of
    its max of JAX's, as K9's split cell."""
    c = _case(**SPLIT_CASE)
    want = _jax_k12(c, layer)
    one = _port_k12(c, layer, splits=1)
    got = _port_k12(c, layer, splits=splits)
    for i in (0, 3, 4, 5, 6):
        np.testing.assert_array_equal(got[i], one[i])
    _near(got[0], want[0])
    for i in (3, 5):
        _flips(got[i], want[i])
    att, att_j = (o[1].astype(np.float32) * o[2][:, None] for o in (got, want))
    _near(att, att_j, rel=SPLIT_TOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_k12_split_matches_two_launch_composition(splits):
    """K12's plain version against the port's two-launch composition (K11,
    RoPE + quantize_kv, K9, K2) with K9 at the same splits, at the JAX
    tests' composition limits."""
    c = _case(**SPLIT_CASE)
    ref = _composed(c, 0, splits=splits)
    got = _port_k12(c, 0, splits=splits)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-2, atol=1e-2)
    for i in (3, 5):
        np.testing.assert_allclose(got[i], ref[i], atol=3)
    for i in (4, 6):
        np.testing.assert_allclose(got[i], ref[i], rtol=2e-2, atol=1e-6)
    np.testing.assert_allclose(got[1].astype(np.float32) * got[2][:, None],
                               ref[1].astype(np.float32) * ref[2][:, None], rtol=2e-2, atol=2e-2)


# (B, KVH, ts, S) -> splits: the 7B shapes of PERF.md's K12 row (batch 8, 1;
# batch 32), a GQA group of 4, short caches
FUSED_SPLITS = [((8, 32, 128, 2048), 8), ((1, 32, 128, 2048), 16), ((32, 32, 128, 2048), 2),
                ((8, 8, 128, 2048), 16), ((8, 32, 128, 512), 1), ((3, 2, 64, 64), 1),
                ((2, 2, 128, 1024), 8)]


@pytest.mark.parametrize("shape,want", FUSED_SPLITS)
def test_fused_splits_rule(shape, want):
    assert tfs.fused_splits(*shape) == want


def test_k12_splits_validated():
    seed, G, KVH, pos = K12_CASES["mha"]
    c = _case(seed, L=2, B=3, KVH=KVH, G=G, hd=128, H=256, S=64, pos=pos)
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="splits"):
            _port_k12(c, 0, splits=bad)


def _header_ints(*names):
    """The int constants ``constexpr int name = expr;`` of the given csrc
    headers, each expression evaluated over the ones read before it."""
    import re
    from pathlib import Path

    csrc = Path(tfs.__file__).resolve().parents[1] / "csrc"
    vals = {}
    for name in names:
        for key, expr in re.findall(r"constexpr int (\w+) = ([^;/]+);", (csrc / name).read_text()):
            try:
                vals[key] = int(eval(expr, {}, dict(vals)))
            except NameError:  # a constant of another header's namespace, or a macro
                pass
    return vals


# (B, D, H, QO): K11 at 7B widths (batch 1, 8, 32), the card tests' shapes
# that are no multiples of 16, and one row
K11_WS_SHAPES = [(1, 4096, 11008, 12288), (8, 4096, 11008, 12288), (32, 4096, 11008, 12288),
                 (20, 64, 96, 128), (3, 24, 96, 48), (1, 8, 8, 24)]


@pytest.mark.parametrize("B,D,H,QO", K11_WS_SHAPES)
def test_step2_workspace_covers_k11_phases(B, D, H, QO):
    """K11 runs the streaming body's phases A-D (csrc/fused_step2.cuh) on
    the workspace of ``step2_workspace_words`` words, as K12: its layout,
    read from the headers' constants (make_phases), ends inside it -- the
    layer's counters (Flow) and the exit count below the tickets, one ticket
    per row group of each phase (16 weight rows; w13 8 columns), the int32
    partials for kMaxRows rows, then h2 quantized for B rows."""
    k = _header_ints("fused_decode.cuh", "fused_step2.cuh")
    rows_u, max_rows = k["kRowsU"], k["kMaxRows"]
    assert max_rows == tfl.MAX_ROWS and B <= max_rows
    flow_words = 4 + 3 + 1 + 1 + 7 + max_rows  # fused_step2.cuh struct Flow
    assert flow_words <= k["kFlowWords"] and 2 * k["kFlowWords"] <= k["kExitWord"]
    assert k["kExitWord"] < k["kTicketBase"]
    tickets = 2 * -(-D // rows_u) + -(-H // 8) + -(-QO // rows_u)
    acc = k["kTicketBase"] + -(-tickets // 4) * 4
    xq3 = acc + max_rows * (2 * D + 2 * H + QO)
    assert xq3 + -(-B * H // 4) <= tfs.step2_workspace_words(B, D, H, QO)


def test_step2_workspace_one_per_width():
    """One workspace per (card, stream, widths): a launch leaves its
    quantized h2 in it, at an offset that another width's layout uses for
    tickets or partials, which every launch must find zero."""
    ws = tfs.step2_workspace("cpu", 0, 64, 96, 128)
    assert tfs.step2_workspace("cpu", 0, 64, 96, 128) is ws
    assert ws.numel() == tfs.step2_workspace_words(tfl.MAX_ROWS, 64, 96, 128)
    assert bool((ws == 0).all())
    other = tfs.step2_workspace("cpu", 0, 24, 96, 48)
    assert other is not ws and tfs.step2_workspace("cpu", 1, 64, 96, 128) is not ws


def test_k12_last_layer_reads_no_cache_and_leaves_outputs():
    """The last launch computes x_next only: a poisoned cache changes
    nothing, and given output rows come back untouched."""
    seed, G, KVH, pos = K12_CASES["mha"]
    c = _case(seed, L=2, B=3, KVH=KVH, G=G, hd=128, H=256, S=64, pos=pos)
    B, hd = c["B"], c["hd"]
    out = (torch.full((B, KVH, hd), 5, dtype=torch.int8), torch.full((B, KVH), 3.0),
           torch.full((B, KVH, hd), 5, dtype=torch.int8), torch.full((B, KVH), 3.0))
    got = _port_k12(c, 1, out=out)
    poisoned = dict(c, kc=np.full_like(c["kc"], 127), ks=np.full_like(c["ks"], 1e9))
    np.testing.assert_array_equal(_port_k12(poisoned, 1)[0], got[0])
    assert all(bool((o == v).all()) for o, v in zip(out, (5, 3.0, 5, 3.0)))
    _near(got[0], _jax_k12(c, 1)[0])


def test_wrappers_run_plain_versions_on_cpu():
    seed, G, KVH, pos = K12_CASES["gqa2"]
    c = _case(seed, L=2, B=3, KVH=KVH, G=G, hd=128, H=256, S=64, pos=pos)
    _kernels.reset_counts()
    _port_k12(c, 0)
    tfl.fused_layer_linear(*_t(c, "x", "attq", "satt"), *_port_weights(c), *_t(c, "rf", "ra"),
                           0, c["L"])
    assert _kernels.PLAIN_CALLS["K12"] == 1 and _kernels.PLAIN_CALLS["K11"] == 1
    assert not any(_kernels.LAUNCHES.values())
    with pytest.raises(ValueError):  # the weights' layer count disagrees
        tfl.fused_layer_linear(*_t(c, "x", "attq", "satt"), *_port_weights(c),
                               *_t(c, "rf", "ra"), 0, 3)
    with pytest.raises(ValueError):  # cos/sin rows of another batch
        tfs.fused_step2_layer(*_t(c, "x", "attq", "satt", "kc", "vc", "ks", "vs", "pos"),
                              torch.ones(2, 64), torch.ones(2, 64), *_port_weights(c),
                              *_t(c, "rf", "ra"), 0, c["L"], KVH * G)


# ------------------------------------------------------------ model level


def _first_rows(jp, jcfg, tp, tcfg, B, T, S, seed):
    """The same fused prefill on both sides (B * T = 32: JAX runs its fused
    body too); returns the caches, the first tokens and their positions."""
    toks, lengths = _prompts(B, T, tcfg.vocab_size, seed)
    assert jl._prefill_w8a8_fast_ok(jp, jcfg, B, T)
    jcache = jl.make_kv_cache(jcfg, B, kv_dtype="int8", seq_len=S)
    tcache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
    jlog, jcache = jl.forward_prefill(
        jp, jcache, jnp.asarray(toks), jnp.zeros((B,), jnp.int32), jnp.asarray(lengths), jcfg,
        logits_mode="last", attn="xla", assume_fresh=True)
    tl.forward_prefill(tp, tcache, torch.tensor(toks), torch.zeros(B, dtype=torch.int32),
                       torch.tensor(lengths), tcfg, logits_mode="last", assume_fresh=True)
    return jcache, tcache, np.asarray(jnp.argmax(jlog, -1), np.int32), lengths.copy()


@pytest.fixture(scope="module", params=["tiny128", "jax_tiny"])
def fused_model(request):
    return build_fused_pair(TINY128 if request.param == "tiny128" else JAX_TINY, jnp.float32,
                            seed=5)


@pytest.mark.parametrize("fused", [True, "mega2"], ids=["two_launch", "mega2"])
def test_fused_decode_matches_jax(fused_model, fused):
    """Two teacher-forced forward_decode steps with the same ``fused`` on
    both sides (attn "flash_dma"), then greedy_decode_loop from the same
    state: tokens equal, logits within LOGITS_TOL, caches within one int8
    step."""
    jcfg, jp, tcfg, tp = fused_model
    B, T, S, steps = 4, 8, 32, 2
    jcache, tcache, nxt, pos = _first_rows(jp, jcfg, tp, tcfg, B, T, S, 6)
    L = tcfg.n_layers
    _kernels.reset_counts()
    for _ in range(steps):
        want, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), jcfg,
                                         attn="flash_dma", fused=fused)
        got, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                   attn="flash_dma", fused=fused)
        _near(got.numpy(), want, LOGITS_TOL)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)  # teacher-force JAX's tokens
        pos = pos + 1
    plain = _kernels.PLAIN_CALLS
    if fused == "mega2":
        assert (plain["K12"], plain["K9"], plain["K8"], plain["K11"]) == (L * steps, steps,
                                                                           steps, 0)
    else:
        assert (plain["K11"], plain["K9"], plain["K8"], plain["K12"]) == (L * steps,
                                                                           L * steps, steps, 0)
    assert plain["K10"] == steps and plain["K3"] == steps
    for tf, jf in zip(_dequant(tcache), _dequant(jcache)):
        _near(tf, jf, 2 ** -7)
    for qn in ("k", "v"):  # the flushed rows: within one int8 step
        d = np.abs(getattr(tcache, qn).numpy().astype(np.int32)
                   - np.asarray(getattr(jcache, qn), np.int32))
        assert d.max() <= 1, d.max()
    want_t, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), steps,
                                      jcfg, attn="flash_dma", fused=fused)
    got_t, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(nxt), torch.tensor(pos), steps,
                                     tcfg, attn="flash_dma", fused=fused)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_prologue_k3_is_rmsnorm_then_quantize_activations():
    """The fused decode's prologue runs K3 on the f32 embedding rows where
    JAX runs rmsnorm then quantize_activations: the same math on an f32
    input, bytes equal at this seed, scales within 2^-20."""
    _, jp, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    toks = np.array([3, 9, 44, 100, 7], np.int32)
    x0 = jp.tok_emb[jnp.asarray(toks)].astype(jnp.float32)
    from tpu_llama.ops.quant import quantize_activations as jqa
    jq, js = jqa(jl.rmsnorm(x0, jp.layers.rms_att[0]))
    tq, ts = tl.rmsnorm_quantize(tp.tok_emb[torch.tensor(toks).long()].float(),
                                 tp.layers.rms_att[0])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=F32_REL, atol=0)


def test_fused_gates():
    _, _, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    cache = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", seq_len=16, device="cpu")
    auto = tl._resolve_fused("auto", "flash_dma", tp, tcfg, cache, 2)
    assert auto is False  # the JAX package on the CPU
    assert tl._resolve_fused(True, "flash_dma", tp, tcfg, cache, 2) is True
    assert tl._resolve_fused("mega2", "xla", tp, tcfg, cache, 2) == "mega2"
    for mode in ("mega", "mega3"):  # opt-in (tests/test_torch_fused_step*.py hold them)
        assert tl._resolve_fused(mode, "xla", tp, tcfg, cache, 2) == mode
    with pytest.raises(ValueError):  # two-launch needs a flash attention
        tl._resolve_fused(True, "xla", tp, tcfg, cache, 2)
    with pytest.raises(ValueError):
        tl._resolve_fused("fast", "flash_dma", tp, tcfg, cache, 2)
    with pytest.raises(ValueError):  # more slots than K11 and K12 take
        tl._resolve_fused("mega2", "flash_dma", tp, tcfg, cache, 33)
    unfused = tl.random_quant_params(tcfg, seed=1, device="cpu")
    assert not tl._fused_path_ok(unfused, tcfg) and tl._fused_path_ok(tp, tcfg)
    for mode in (True, "mega2"):
        with pytest.raises(ValueError):
            tl.forward_decode(unfused, cache, torch.tensor([1, 2]), torch.tensor([0, 0]), tcfg,
                              attn="flash_dma", fused=mode)
    odd = ModelConfig(dim=4 * 6, hidden_dim=32, n_layers=1, n_heads=4, n_kv_heads=4,
                      vocab_size=16, seq_len=16)  # head_dim 6: not a multiple of 4
    assert not tl._mega2_path_ok(tp, odd, tl.make_kv_cache(odd, 2, kv_dtype="int8", device="cpu"), 2)

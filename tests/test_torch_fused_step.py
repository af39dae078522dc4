"""Port parity of mega: K27 ``fused_step_layer`` (plain version) against the
JAX package's Pallas kernel run in interpret mode, as its own tests run it
on the CPU, then ``forward_decode(fused="mega")`` against the JAX
package's.  Inputs are made with numpy from a seed and handed to both
packages; JAX gets its 32-row padding and its [L, in, out] weights, the
port the real rows and K-major weights.

Limits, and why.  The port's plain version is K9's plain cell, K2's row
quant and K11's phases (the kernel's rounding points: q divided by
sqrt(hd), bf16 q and p * vs in the cache dots, the fresh row scored with
the unrounded q; fused_step.py:152-198).  XLA on the CPU contracts
``a * b + c`` into FMAs inside the interpreted body and sums the dots in
its own order, and the JAX kernel's key block (128 rows, halved to divide
S) is the port's block at these shapes, so:

* x_next and qkv_next within 2^-20 of max |value| (a few f32 ulps of the
  largest entries) where no int8 of the attention output moved; an int8
  moved by one step would show as ~1e-3, and none moves at these seeds;
* against the port's own two-launch composition (K9, K2, K11 through their
  wrappers): equal, and the quantized attention output equal, since the
  plain version is that composition step for step;
* model level (the JAX tests' hd-128 configs, f32 activations, after the
  same fused prefill): greedy tokens equal at every step, every step's
  logits within 1e-4 of max |logit|, the flushed cache rows within one int8
  step -- the limits ``test_torch_fused_decode.py`` holds the two-launch
  decode to, whose arithmetic mega's is; and the port's mega, two-launch
  and mega2 streams equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_llama.models import llama as jl
from tpu_llama.ops import attention as jatt
from tpu_llama.ops import fused_step as jfst
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import fused_layer as tfl
from tpu_llama_torch.ops import fused_step as tfst
from tpu_llama_torch.ops.quant import quantize_activations, quantize_activations_plain

from test_torch_fused_decode import (JAX_TINY, LOGITS_TOL, SPLIT_CASE, SPLIT_TOL, _case,
                                     _dequant, _first_rows, _jax_weights, _near, _pad,
                                     _port_weights, _t)
from test_torch_model import TINY128, build_fused_pair

torch.set_num_threads(1)


def _k27_case(seed, L, B, KVH, G, hd, H, S, pos):
    """``_case`` plus layer l's roped queries and the step's fresh rows."""
    c = _case(seed, L=L, B=B, KVH=KVH, G=G, hd=hd, H=H, S=S, pos=pos)
    rng = np.random.default_rng(seed + 100)
    c["q"] = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    for n in ("nk", "nv"):
        c[n] = rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8)
        c[n + "s"] = rng.uniform(0.005, 0.02, (B, KVH)).astype(np.float32)
    return c


def _jax_k27(c, layer):
    out = jfst.fused_step_layer(
        _pad(c["x"]), *(jnp.asarray(c[k]) for k in ("q", "nk", "nv", "nks", "nvs", "kc", "vc",
                                                     "ks", "vs", "pos")),
        *_jax_weights(c), jnp.asarray(c["rf"]), jnp.asarray(c["ra"]), jnp.int32(layer), c["L"])
    return [np.asarray(o)[:c["B"]] for o in out]


def _port_k27(c, layer, fn=tfst.fused_step_layer, **kw):
    out = fn(*_t(c, "x", "q", "nk", "nv", "nks", "nvs", "kc", "vc", "ks", "vs", "pos"),
             *_port_weights(c), *_t(c, "rf", "ra"), layer, c["L"], **kw)
    return [o.numpy() for o in out]


K27_CASES = {"mha": (11, 1, 2, [5, 33], 64, 3), "gqa2": (12, 2, 1, [0, 7, 31], 32, 2)}


@pytest.mark.parametrize("case,layer", [("mha", 0), ("mha", 1), ("mha", 2), ("gqa2", 0),
                                        ("gqa2", 1)])
def test_k27_plain_matches_jax(case, layer):
    """The shapes of tests/test_fused_step.py's parity tests, every layer."""
    seed, G, KVH, pos, S, L = K27_CASES[case]
    c = _k27_case(seed, L=L, B=len(pos), KVH=KVH, G=G, hd=128, H=384 if L == 3 else 256, S=S,
                  pos=pos)
    want = _jax_k27(c, layer)
    got = _port_k27(c, layer)
    _near(got[0], want[0])
    if layer + 1 < c["L"]:
        _near(got[1], want[1])


def test_k27_pos_zero_reads_only_fresh_row():
    """pos = 0 (tests/test_fused_step.py:112): the fresh row is the whole
    softmax; a poisoned cache changes nothing, and the result still
    matches JAX's."""
    c = _k27_case(13, L=2, B=2, KVH=2, G=1, hd=128, H=256, S=32, pos=[0, 0])
    got = _port_k27(c, 0)
    poisoned = dict(c, kc=np.full_like(c["kc"], 127), vc=np.full_like(c["vc"], 127),
                    ks=np.full_like(c["ks"], 1e9), vs=np.full_like(c["vs"], 1e9))
    for a, b in zip(_port_k27(poisoned, 0), got):
        np.testing.assert_array_equal(a, b)
    want = _jax_k27(c, 0)
    _near(got[0], want[0])
    _near(got[1], want[1])


@pytest.mark.parametrize("case,layer", [("mha", 0), ("mha", 2), ("gqa2", 0)])
def test_k27_equals_two_launch_composition(case, layer):
    """K27 is K9, K2 and K11 in one launch: the port's two-launch layer
    through those wrappers gives the same outputs and quantized attention."""
    seed, G, KVH, pos, S, L = K27_CASES[case]
    c = _k27_case(seed, L=L, B=len(pos), KVH=KVH, G=G, hd=128, H=256, S=S, pos=pos)
    B, D = c["B"], c["D"]
    att = tatt.flash_decode_attention_dma(*_t(c, "q", "kc", "vc", "pos", "nk", "nv", "ks", "vs",
                                              "nks", "nvs"), layer=layer)
    attq, satt = quantize_activations(att.reshape(B, D))
    x_ref, qkv_ref = tfl.fused_layer_linear(*_t(c, "x"), attq, satt, *_port_weights(c),
                                            *_t(c, "rf", "ra"), layer, L)
    att_out = (torch.empty(B, D, dtype=torch.int8), torch.empty(B))
    x, qkv = _port_k27(c, layer, att_out=att_out)
    assert torch.equal(att_out[0], attq) and torch.equal(att_out[1], satt)
    np.testing.assert_array_equal(x, x_ref.numpy())
    if layer + 1 < L:
        np.testing.assert_array_equal(qkv, qkv_ref.numpy())


def _k27_att(c, layer, splits, fn=tfst.fused_step_layer):
    """K27's (x_next, qkv, attq, satt) at ``splits``."""
    att = (torch.empty(c["B"], c["D"], dtype=torch.int8), torch.empty(c["B"]))
    x, qkv = _port_k27(c, layer, fn=fn, att_out=att, splits=splits)
    return x, qkv, att[0].numpy(), att[1].numpy()


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("layer", [0, 1])
def test_k27_plain_splits_match_jax(splits, layer):
    """K27's cells at more than one split (K12's SPLIT_CASE: 512 rows in
    key blocks of 128, slots ending in the first, a middle and the last
    block).  Rows are independent in the linear phases, so in every row
    whose attention int8 and scale equal the one-split plain version's,
    x_next and qkv equal it bit for bit and JAX's within the limits above;
    the attention int8 moves by at most one step (p rounds against each
    split's own max: within half a step of the one-split output before the
    quant); the dequantized attention output within 2^-8 of its max of
    JAX's (its K9 in interpret mode, quantized by K2's plain version), as
    K9's split cell."""
    c = _k27_case(**SPLIT_CASE)
    B, D = c["B"], c["D"]
    one = _k27_att(c, layer, 1, tfst.fused_step_layer_plain)
    got = _k27_att(c, layer, splits)
    want = _jax_k27(c, layer)
    same = [b for b in range(B)
            if np.array_equal(got[2][b], one[2][b]) and got[3][b] == one[3][b]]
    assert 0 in same  # slot 0 (pos 0) attends to its fresh row alone
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][same], one[i][same])
        _near(got[i][same], want[i][same])
    assert np.abs(got[2].astype(np.int32) - one[2].astype(np.int32)).max() <= 1
    att_j = jatt.flash_decode_attention_dma(
        *(jnp.asarray(c[k]) for k in ("q", "kc", "vc", "pos", "nk", "nv", "ks", "vs", "nks",
                                      "nvs")), layer=jnp.int32(layer))
    aq, asc = quantize_activations_plain(torch.tensor(np.asarray(att_j)).reshape(B, D))
    _near(got[2].astype(np.float32) * got[3][:, None], (aq.float() * asc[:, None]).numpy(),
          rel=SPLIT_TOL)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("layer", [0, 2])
def test_k27_split_matches_composition(splits, layer):
    """K27's plain version at ``splits`` is K9's plain version at the same
    splits, then K2's, then K11's phases (``linear_phases_plain``), bit for
    bit -- the contract the card holds K27 to (K9, K2 and K11 launched in
    turn); layer 2 is the last (qkv untouched)."""
    c = _k27_case(**SPLIT_CASE)
    B, D, L = c["B"], c["D"], c["L"]
    att = tatt.flash_decode_attention_dma_plain(
        *_t(c, "q", "kc", "vc", "pos", "nk", "nv", "ks", "vs", "nks", "nvs"), layer=layer,
        splits=splits)
    attq, satt = quantize_activations_plain(att.reshape(B, D))
    views = tfl.layer_views(*_port_weights(c), *_t(c, "rf", "ra"), layer, L)
    x_ref, qkv_ref = tfl.linear_phases_plain(torch.tensor(c["x"]), attq, satt, *views,
                                             last=layer + 1 == L)
    x, qkv, aq, asc = _k27_att(c, layer, splits)
    np.testing.assert_array_equal(aq, attq.numpy())
    np.testing.assert_array_equal(asc, satt.numpy())
    np.testing.assert_array_equal(x, x_ref.numpy())
    if qkv_ref is not None:
        np.testing.assert_array_equal(qkv, qkv_ref.numpy())


def test_k27_last_layer_leaves_qkv_and_counts_plain():
    seed, G, KVH, pos, S, L = K27_CASES["gqa2"]
    c = _k27_case(seed, L=L, B=len(pos), KVH=KVH, G=G, hd=128, H=256, S=S, pos=pos)
    sentinel = torch.full((c["B"], c["D"] + 2 * KVH * 128), 7.0)
    _kernels.reset_counts()
    x, qkv = tfst.fused_step_layer(*_t(c, "x", "q", "nk", "nv", "nks", "nvs", "kc", "vc", "ks",
                                       "vs", "pos"), *_port_weights(c), *_t(c, "rf", "ra"),
                                   L - 1, L, qkv_out=sentinel)
    assert qkv is sentinel and bool((qkv == 7.0).all())
    assert _kernels.PLAIN_CALLS["K27"] == 1 and not any(_kernels.LAUNCHES.values())
    _near(x.numpy(), _jax_k27(c, L - 1)[0])


def test_k27_rejects_what_it_does_not_take():
    seed, G, KVH, pos, S, L = K27_CASES["gqa2"]
    c = _k27_case(seed, L=L, B=len(pos), KVH=KVH, G=G, hd=128, H=256, S=S, pos=pos)
    args = _t(c, "x", "q", "nk", "nv", "nks", "nvs", "kc", "vc", "ks", "vs", "pos")
    rest = (*_port_weights(c), *_t(c, "rf", "ra"))
    with pytest.raises(ValueError):  # the weights' layer count disagrees
        tfst.fused_step_layer(*args, *rest, 0, L + 1)
    with pytest.raises(ValueError):  # layer outside the stack
        tfst.fused_step_layer(*args, *rest, L, L)
    fp = [a.float() for a in args[6:8]]  # an fp cache: K27 is INT8-only, as in JAX
    with pytest.raises((ValueError, TypeError)):
        tfst.fused_step_layer(*args[:6], *fp, None, None, args[10], *rest, 0, L)
    with pytest.raises(ValueError):  # att_out of the wrong shape
        tfst.fused_step_layer(*args, *rest, 0, L, att_out=(torch.empty(1, 1, dtype=torch.int8),
                                                           torch.empty(1)))
    for bad in (0, -1, 1.5):  # splits must be a positive int
        with pytest.raises(ValueError):
            tfst.fused_step_layer(*args, *rest, 0, L, splits=bad)


# ------------------------------------------------------------ model level


@pytest.fixture(scope="module", params=["tiny128", "jax_tiny"])
def mega_model(request):
    return build_fused_pair(TINY128 if request.param == "tiny128" else JAX_TINY, jnp.float32,
                            seed=5)


def test_forward_decode_mega_matches_jax(mega_model):
    """Two teacher-forced ``forward_decode(fused="mega")`` steps on both
    sides, then ``greedy_decode_loop`` from the same state."""
    jcfg, jp, tcfg, tp = mega_model
    B, T, S, steps = 4, 8, 32, 2
    jcache, tcache, nxt, pos = _first_rows(jp, jcfg, tp, tcfg, B, T, S, 6)
    assert jl._mega_path_ok(jp, jcfg, jcache, B)
    L = tcfg.n_layers
    _kernels.reset_counts()
    for _ in range(steps):
        want, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), jcfg,
                                         attn="flash_dma", fused="mega")
        got, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                   fused="mega")
        _near(got.numpy(), want, LOGITS_TOL)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)  # teacher-force JAX's tokens
        pos = pos + 1
    plain = _kernels.PLAIN_CALLS
    assert (plain["K27"], plain["K8"], plain["K3"], plain["K10"]) == (L * steps, steps, steps,
                                                                       steps)
    assert plain["K9"] == plain["K11"] == plain["K12"] == plain["K26"] == 0
    for tf, jf in zip(_dequant(tcache), _dequant(jcache)):
        _near(tf, jf, 2 ** -7)
    for qn in ("k", "v"):  # the flushed rows: within one int8 step
        d = np.abs(getattr(tcache, qn).numpy().astype(np.int32)
                   - np.asarray(getattr(jcache, qn), np.int32))
        assert d.max() <= 1, d.max()
    want_t, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), steps,
                                      jcfg, attn="flash_dma", fused="mega")
    got_t, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(nxt), torch.tensor(pos), steps,
                                     tcfg, fused="mega")
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def greedy_streams(tcfg, tp, modes, steps=6, seed=9):
    """Each fused decode mode's greedy stream of ``steps`` steps from the
    same fused prefill of three prompts: {mode: (tokens [steps, B], logits
    [steps, B, V])}."""
    B, T, S = 3, 8, 32
    toks = np.random.default_rng(seed).integers(3, tcfg.vocab_size, (B, T)).astype(np.int32)
    lengths = np.array([8, 5, 3], np.int32)
    out = {}
    for mode in modes:
        cache = tl.make_kv_cache(tcfg, B, kv_dtype="int8", seq_len=S, device="cpu")
        logits, _ = tl.forward_prefill(tp, cache, torch.tensor(toks),
                                       torch.zeros(B, dtype=torch.int32), torch.tensor(lengths),
                                       tcfg, logits_mode="last", assume_fresh=True)
        pos, toks_m, logs = torch.tensor(lengths), [], []
        for _ in range(steps):
            toks_m.append(logits.argmax(-1))
            logits, _ = tl.forward_decode(tp, cache, toks_m[-1], pos, tcfg, attn="flash_dma",
                                          fused=mode)
            logs.append(logits)
            pos = pos + 1
        out[mode] = torch.stack(toks_m), torch.stack(logs)
    return out


# mega2 (K12) rounds q and h2 to bf16 where mega and the two-launch decode
# keep f32 (fused_step2.py:217-224, :256-257), so its tokens may part from
# theirs where the top two logits are this close, as a share of max |logit|
# (the card tests' NEAR_TIE rule; where mega2 parts from mega on the tiny
# model below they are 4.1e-3 apart).
NEAR_TIE = 1e-2


def assert_same_until_near_tie(ref, got, tie=NEAR_TIE):
    """Greedy streams equal, slot by slot, up to the first step where the
    reference's top two logits are within ``tie`` of its max |logit|."""
    (rt, rl), (gt, _) = ref, got
    for b in range(rt.shape[1]):
        part = next((i for i in range(rt.shape[0]) if rt[i, b] != gt[i, b]), None)
        if part is None:
            continue
        prev = rl[part - 1, b] if part else None
        assert prev is not None, f"slot {b}: the first token differs"
        top2 = prev.topk(2).values
        assert top2[0] - top2[1] < tie * prev.abs().max(), (b, part, rt[:, b], gt[:, b])


def test_mega_streams_equal_two_launch_and_mega2():
    """The port's mega, two-launch and mega2 greedy streams from the same
    prefill: mega's tokens and logits equal the two-launch decode's bit for
    bit (the same plain arithmetic); mega2's tokens equal them up to a near
    tie (NEAR_TIE)."""
    _, _, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    s = greedy_streams(tcfg, tp, ("mega", True, "mega2"))
    assert torch.equal(s["mega"][0], s[True][0]) and torch.equal(s["mega"][1], s[True][1])
    assert_same_until_near_tie(s["mega2"], s["mega"])


def test_mega_gate_and_auto():
    """``"auto"`` never resolves to mega (JAX's never does); mega refuses a
    paged cache, an fp cache, unfused weights and more than 32 slots."""
    _, _, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    dense = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", seq_len=16, device="cpu")
    assert tl._resolve_fused("mega", "xla", tp, tcfg, dense, 2) == "mega"
    assert tl._resolve_fused("auto", "flash_dma", tp, tcfg, dense, 2) is False
    fp = tl.make_kv_cache(tcfg, 2, kv_dtype="float32", seq_len=16, device="cpu")
    paged = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", seq_len=32, paged=True, num_pages=5,
                             page_size=16, device="cpu")
    for cache in (fp, paged):
        assert tl._resolve_fused("auto", "flash_dma", tp, tcfg, cache, 2) is False
        with pytest.raises(ValueError, match="mega decode requires"):
            tl._resolve_fused("mega", "flash_dma", tp, tcfg, cache, 2)
    with pytest.raises(ValueError, match="mega decode requires"):
        tl._resolve_fused("mega", "flash_dma", tp, tcfg, dense, 33)
    unfused = tl.random_quant_params(tcfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match="mega decode requires"):
        tl.forward_decode(unfused, dense, torch.tensor([1, 2]), torch.tensor([0, 0]), tcfg,
                          fused="mega")
    cfg = ModelConfig(**JAX_TINY)
    assert tl._mega_path_ok(tp, cfg, tl.make_kv_cache(cfg, 2, kv_dtype="int8", device="cpu"), 2)

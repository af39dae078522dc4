"""Port parity of mega3: K26 ``fused_step3_pair`` (plain version) against the
JAX package's Pallas kernel run in interpret mode, as its own tests run it
on the CPU, then ``forward_decode(fused="mega3")`` against the JAX
package's.  Inputs are made with numpy from a seed and handed to both
packages; JAX gets its 32-row padding and its [L, in, out] weights, the
port the real rows and K-major weights.

Limits, and why.  K26 is two of K12's layers in one launch, so its plain
version is two chained calls of K12's, and the JAX kernel's contract is the
same (tests/test_fused_step3.py: one pair equals two chained mega2
launches).  So K26 is held to the JAX kernel at the limits
``test_torch_fused_decode.py`` holds K12 to (XLA on the CPU contracts FMAs
inside the interpreted body; the port rounds every step):

* x_next within 2^-20 of max |value|;
* the int8 outputs (both layers' fresh K/V rows, layer l0 + 2's quantized
  attention input) at most one step apart on at most 1% of entries; their
  scales within 2^-20 relative; the dequantized attention within 2^-20 of
  its max;

and to two chained plain K12 calls exactly.  Model level (the 2-layer
hd-128 model, f32 activations, after the same fused prefill): greedy tokens
equal JAX's mega3 at every step, logits within 1e-4 of max |logit|, the
flushed cache rows within one int8 step; on a 4-layer model the port's
mega3 tokens and logits equal its mega2's exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_llama.models import llama as jl
from tpu_llama.ops import fused_step2 as jfs
from tpu_llama.ops import fused_step3 as jfs3
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import fused_step2 as tfs
from tpu_llama_torch.ops import fused_step3 as tfs3

from test_torch_fused_decode import (F32_REL, LOGITS_TOL, _case, _dequant, _first_rows, _flips,
                                     _jax_weights, _near, _pad, _port_weights, _t)
from test_torch_fused_step import greedy_streams
from test_torch_model import TINY128, build_fused_pair

torch.set_num_threads(1)

TINY128_L4 = dict(TINY128, n_layers=4)


def _jax_k26(c, l0):
    TS = jfs.step2_block_s(c["S"])
    base, dcell, doff, total = jfs.decode_dma_descs(jnp.asarray(c["pos"]), c["B"], c["S"], TS)
    rc, rsa, rsb = jfs.rope_tables(jnp.asarray(c["cos"]), jnp.asarray(c["sin"]), 32)
    x, attq, satt, rows = jfs3.fused_step3_pair(
        _pad(c["x"]), _pad(c["attq"]), _pad(c["satt"]),
        *(jnp.asarray(c[k]) for k in ("kc", "vc", "ks", "vs", "pos")), rc, rsa, rsb, base,
        dcell, doff, total, *_jax_weights(c), jnp.asarray(c["rf"]), jnp.asarray(c["ra"]),
        jnp.int32(l0), c["L"], c["KVH"] * c["G"], block_s=TS)
    B = c["B"]
    rows = [np.asarray(r) for r in rows]  # each [2, B, ...]: layers l0 + 1, l0 + 2
    return ([np.asarray(o)[:B] for o in (x, attq, satt)],
            [[r[h] for r in rows] for h in (0, 1)])


def _port_k26(c, l0, fn=tfs3.fused_step3_pair, **kw):
    x, attq, satt, rows1, rows2 = fn(
        *_t(c, "x", "attq", "satt", "kc", "vc", "ks", "vs", "pos", "cos", "sin"),
        *_port_weights(c), *_t(c, "rf", "ra"), l0, c["L"], c["KVH"] * c["G"], **kw)
    return ([o.numpy() for o in (x, attq, satt)],
            [[r.numpy() for r in rows] for rows in (rows1, rows2)])


def _held_to_jax(got, want, last):
    (gx, gq, gs), grows = got
    (wx, wq, ws), wrows = want
    _near(gx, wx)
    for h in (0,) if last else (0, 1):  # the last pair's second rows are garbage in JAX
        for i in (0, 2):  # kq, vq
            _flips(grows[h][i], wrows[h][i])
        for i in (1, 3):  # their scales
            np.testing.assert_allclose(grows[h][i], wrows[h][i], rtol=F32_REL, atol=0)
    if last:
        return  # JAX's attq_next is garbage on the last pair
    _flips(gq, wq)
    np.testing.assert_allclose(gs, ws, rtol=F32_REL, atol=0)
    _near(gq.astype(np.float32) * gs[:, None], wq.astype(np.float32) * ws[:, None])


# (seed, G, KVH, pos, S, H): the shapes of tests/test_fused_step3.py
K26_CASES = {"mha": (31, 1, 2, [5, 33], 64, 384), "gqa2": (32, 2, 1, [0, 7, 31], 32, 256)}


@pytest.mark.parametrize("case,l0", [("mha", 0), ("mha", 2), ("gqa2", 0), ("gqa2", 2)])
def test_k26_plain_matches_jax(case, l0):
    seed, G, KVH, pos, S, H = K26_CASES[case]
    c = _case(seed, L=4, B=len(pos), KVH=KVH, G=G, hd=128, H=H, S=S, pos=pos)
    _held_to_jax(_port_k26(c, l0), _jax_k26(c, l0), last=l0 + 2 == c["L"])


@pytest.mark.parametrize("case,l0", [("mha", 0), ("mha", 2), ("gqa2", 0)])
def test_k26_equals_two_chained_k12(case, l0):
    """The contract on the card, here on the plain versions: one K26 pair is
    K12 for l0, then K12 for l0 + 1 on its outputs, exactly; the rows land
    in the ``out`` buffers given (the last pair leaves its second set
    untouched)."""
    seed, G, KVH, pos, S, H = K26_CASES[case]
    c = _case(seed, L=4, B=len(pos), KVH=KVH, G=G, hd=128, H=H, S=S, pos=pos)
    nh = KVH * G
    args = _t(c, "x", "attq", "satt", "kc", "vc", "ks", "vs", "pos", "cos", "sin")
    rest = (*_port_weights(c), *_t(c, "rf", "ra"))
    x1, attq1, satt1, *rows1 = tfs.fused_step2_layer(*args, *rest, l0, c["L"], nh)
    ref = tfs.fused_step2_layer(x1, attq1, satt1, *args[3:], *rest, l0 + 1, c["L"], nh)
    B, hd = c["B"], c["hd"]

    def bufs():
        return (torch.full((B, KVH, hd), 5, dtype=torch.int8), torch.full((B, KVH), 3.0),
                torch.full((B, KVH, hd), 5, dtype=torch.int8), torch.full((B, KVH), 3.0))

    out = (bufs(), bufs())
    x, attq, satt, got1, got2 = tfs3.fused_step3_pair(*args, *rest, l0, c["L"], nh, out=out)
    assert all(a is b for a, b in zip(got1 + got2, out[0] + out[1]))
    assert torch.equal(x, ref[0])
    for a, b in zip(got1, rows1):
        assert torch.equal(a, b)
    if l0 + 2 == c["L"]:
        assert all(bool((t == v).all()) for t, v in zip(got2, (5, 3.0, 5, 3.0)))
        return
    assert torch.equal(attq, ref[1]) and torch.equal(satt, ref[2])
    for a, b in zip(got2, ref[3:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("l0", [0, 2])
def test_k26_splits_equal_two_chained_k12(splits, l0):
    """At more than one split of the trailing cells (a 512-row cache in
    128-row key blocks): one K26 pair is two chained K12 plain calls at the
    same splits, exactly."""
    c = _case(33, L=4, B=3, KVH=2, G=1, hd=128, H=256, S=512, pos=[0, 300, 511])
    nh = c["KVH"] * c["G"]
    args = _t(c, "x", "attq", "satt", "kc", "vc", "ks", "vs", "pos", "cos", "sin")
    rest = (*_port_weights(c), *_t(c, "rf", "ra"))
    x1, attq1, satt1, *rows1 = tfs.fused_step2_layer(*args, *rest, l0, c["L"], nh,
                                                     splits=splits)
    ref = tfs.fused_step2_layer(x1, attq1, satt1, *args[3:], *rest, l0 + 1, c["L"], nh,
                                splits=splits)
    x, attq, satt, got1, got2 = tfs3.fused_step3_pair(*args, *rest, l0, c["L"], nh,
                                                      splits=splits)
    assert torch.equal(x, ref[0])
    assert all(torch.equal(a, b) for a, b in zip(got1, rows1))
    if l0 + 2 < c["L"]:
        assert torch.equal(attq, ref[1]) and torch.equal(satt, ref[2])
        assert all(torch.equal(a, b) for a, b in zip(got2, ref[3:]))


def test_k26_last_pair_reads_no_layer_past_l0_plus_1():
    """The last pair (tests/test_fused_step3.py:103): poisoning every layer
    of the cache but l0 + 1 changes nothing."""
    c = _case(33, L=4, B=2, KVH=2, G=1, hd=128, H=256, S=32, pos=[9, 13])
    l0 = c["L"] - 2
    got = _port_k26(c, l0)
    poisoned = dict(c)
    for k, v in (("kc", 127), ("vc", 127), ("ks", 1e9), ("vs", 1e9)):
        a = c[k].copy()
        a[np.arange(c["L"]) != l0 + 1] = v
        poisoned[k] = a
    np.testing.assert_array_equal(_port_k26(poisoned, l0)[0][0], got[0][0])
    _held_to_jax(got, _jax_k26(c, l0), last=True)


def test_k26_counts_plain_and_rejects():
    seed, G, KVH, pos, S, H = K26_CASES["gqa2"]
    c = _case(seed, L=4, B=len(pos), KVH=KVH, G=G, hd=128, H=H, S=S, pos=pos)
    _kernels.reset_counts()
    _port_k26(c, 0)
    assert _kernels.PLAIN_CALLS["K26"] == 1 and _kernels.PLAIN_CALLS["K12"] == 0
    assert not any(_kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="even"):  # an odd first layer
        _port_k26(c, 1)
    odd = _case(seed, L=3, B=len(pos), KVH=KVH, G=G, hd=128, H=H, S=S, pos=pos)
    with pytest.raises(ValueError, match="even"):  # an odd layer count
        _port_k26(odd, 0)


# ------------------------------------------------------------ model level


def test_forward_decode_mega3_matches_jax():
    """Two teacher-forced ``forward_decode(fused="mega3")`` steps on both
    sides, then ``greedy_decode_loop`` from the same state, on the 2-layer
    hd-128 model (one pair: the last-pair path; the op tests above hold a
    first pair to JAX's).  On the 4-layer model of
    ``test_mega3_streams_equal_mega2`` the port and JAX part by an int8
    step upstream of the decode, in every fused mode alike (slot 0's
    logits 3.97e-2 apart in mega2 and mega3, 4.09e-2 in the two-launch
    decode), so there mega3 is held to the port's mega2 instead."""
    jcfg, jp, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    B, T, S, steps = 4, 8, 32, 2
    jcache, tcache, nxt, pos = _first_rows(jp, jcfg, tp, tcfg, B, T, S, 6)
    assert jl._mega3_path_ok(jp, jcfg, jcache, B)
    L = tcfg.n_layers
    _kernels.reset_counts()
    for _ in range(steps):
        want, jcache = jl.forward_decode(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), jcfg,
                                         attn="flash_dma", fused="mega3")
        got, _ = tl.forward_decode(tp, tcache, torch.tensor(nxt), torch.tensor(pos), tcfg,
                                   fused="mega3")
        _near(got.numpy(), want, LOGITS_TOL)
        nxt = np.asarray(jnp.argmax(want, -1), np.int32)  # teacher-force JAX's tokens
        pos = pos + 1
    plain = _kernels.PLAIN_CALLS
    assert (plain["K26"], plain["K9"], plain["K8"], plain["K10"]) == (L // 2 * steps, steps,
                                                                       steps, steps)
    assert plain["K12"] == plain["K11"] == plain["K27"] == 0
    for tf, jf in zip(_dequant(tcache), _dequant(jcache)):
        _near(tf, jf, 2 ** -7)
    for qn in ("k", "v"):  # the flushed rows: within one int8 step
        d = np.abs(getattr(tcache, qn).numpy().astype(np.int32)
                   - np.asarray(getattr(jcache, qn), np.int32))
        assert d.max() <= 1, d.max()
    want_t, _ = jl.greedy_decode_loop(jp, jcache, jnp.asarray(nxt), jnp.asarray(pos), steps,
                                      jcfg, attn="flash_dma", fused="mega3")
    got_t, _ = tl.greedy_decode_loop(tp, tcache, torch.tensor(nxt), torch.tensor(pos), steps,
                                     tcfg, fused="mega3")
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_mega3_streams_equal_mega2():
    """mega3's greedy tokens and logits equal mega2's exactly: the same
    plain arithmetic, two layers a call."""
    _, _, tcfg, tp = build_fused_pair(TINY128_L4, jnp.float32, seed=5)
    s = greedy_streams(tcfg, tp, ("mega3", "mega2"))
    assert torch.equal(s["mega3"][0], s["mega2"][0])
    assert torch.equal(s["mega3"][1], s["mega2"][1])


def test_mega3_gate_and_auto():
    """``"auto"`` never resolves to mega3 (JAX's never does); mega3 refuses
    an odd layer count, a paged cache, an fp cache and more than 32 slots
    with JAX's message."""
    _, _, tcfg, tp = build_fused_pair(TINY128, jnp.float32, seed=5)
    dense = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", seq_len=16, device="cpu")
    assert tl._resolve_fused("mega3", "xla", tp, tcfg, dense, 2) == "mega3"
    assert tl._resolve_fused("auto", "flash_dma", tp, tcfg, dense, 2) is False
    fp = tl.make_kv_cache(tcfg, 2, kv_dtype="bfloat16", seq_len=16, device="cpu")
    paged = tl.make_kv_cache(tcfg, 2, kv_dtype="int8", seq_len=32, paged=True, num_pages=5,
                             page_size=16, device="cpu")
    for cache, B in ((fp, 2), (paged, 2), (dense, 33)):
        with pytest.raises(ValueError, match="an even layer count"):
            tl._resolve_fused("mega3", "flash_dma", tp, tcfg, cache, B)
    odd = ModelConfig(**dict(TINY128, n_layers=3))
    p_odd = tl.random_quant_params(odd, seed=2, fuse=True, device="cpu")
    c_odd = tl.make_kv_cache(odd, 2, kv_dtype="int8", seq_len=16, device="cpu")
    assert tl._mega2_path_ok(p_odd, odd, c_odd, 2) and not tl._mega3_path_ok(p_odd, odd, c_odd, 2)
    with pytest.raises(ValueError, match="an even layer count"):
        tl.forward_decode(p_odd, c_odd, torch.tensor([1, 2]), torch.tensor([0, 0]), odd,
                          fused="mega3")

"""The Q8_0 weight format and K25 against the JAX package: ``quantize_q8``
and ``dequantize`` byte-equal (the port stores both arrays K-major, the
transposes of JAX's), padding included; ``q8_matmul_plain`` against the
JAX ``q8_matmul`` (Pallas in interpret mode on the CPU); ``quantize_params``
and ``random_quant_params`` in mode "q8_0" as JAX builds them.

q8_matmul tolerance: max |port - jax| <= 1e-5 * max |jax|.  Both multiply
bf16(x) by bf16(bf16(q) * bf16(s)) -- products exact in f32 -- and sum in
f32; only the order of the sums differs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig as JaxModelConfig
from tpu_llama.io.checkpoint import make_random_weights
from tpu_llama.models import llama as jl
from tpu_llama.ops import matmul as jmm
from tpu_llama.ops import quant as jq
from tpu_llama_torch import convert
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import matmul as tmm
from tpu_llama_torch.ops import quant as tq

torch.set_num_threads(1)

TOL = 1e-5
TINY_GQA = dict(dim=48, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                vocab_size=320, seq_len=64, shared_weights=False)


def _port_of(j: jq.QuantTensor) -> tq.QuantTensor:
    return convert._weight_from_numpy(
        {"q": np.asarray(j.q), "s": np.asarray(j.s), "logical_in": j.logical_in,
         "logical_out": j.logical_out}, "cpu")


def _assert_same(t: tq.QuantTensor, j: jq.QuantTensor):
    np.testing.assert_array_equal(t.q.numpy(), np.swapaxes(np.asarray(j.q), -1, -2))
    np.testing.assert_array_equal(t.s.numpy(), np.swapaxes(np.asarray(j.s), -1, -2))
    assert (t.logical_in, t.logical_out, t.group_size) == (j.logical_in, j.logical_out,
                                                           j.group_size)


@pytest.mark.parametrize("shape,g", [
    ((48, 130), None),       # in padded to 128, out to 256
    ((200, 130), None),      # in 200 -> 256 (g 32: alignment 256)
    ((256, 128), 16),        # no padding, groups of 16
    ((2, 96, 64), 64),       # stacked, in padded to 512
    ((2, 1024, 384), None),  # g 64 without padding
])
def test_quantize_q8_bytes_equal_jax(shape, g):
    w = (np.random.default_rng(sum(shape)).standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3, :] = 0.0  # a zero group row
    j = jq.quantize_q8(jnp.asarray(w), g)
    t = tq.quantize_q8(torch.tensor(w), g)
    _assert_same(t, j)
    np.testing.assert_array_equal(tq.dequantize(t).numpy(), np.asarray(jq.dequantize(j)))
    assert tq.dequantize(t, torch.bfloat16).dtype == torch.bfloat16


def test_group_size_and_alignment_follow_jax():
    for n in (48, 128, 200, 256, 512, 4096, 11008, 5120, 13824, 288, 768):
        assert tq.pick_group_size(n) == jq.pick_group_size(n)
        for g in (16, 32, 64):
            assert tq.kernel_alignment(g) == jq.kernel_alignment(g)


@pytest.mark.parametrize("x_dtype", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,n_in,n_out", [(5, 200, 130), (8, 256, 384), (40, 48, 130)])
def test_q8_matmul_plain_matches_jax(M, n_in, n_out, x_dtype):
    rng = np.random.default_rng(M + n_in)
    w = (rng.standard_normal((n_in, n_out)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, n_in)).astype(np.float32)
    j = jq.quantize_q8(jnp.asarray(w))
    xj = jnp.asarray(x).astype(x_dtype[0])
    want = jmm.q8_matmul(xj, j, out_dtype=x_dtype[0])
    before = _kernels.PLAIN_CALLS["K25"]
    got = tmm.q8_matmul(torch.tensor(np.asarray(xj.astype(jnp.float32))).to(x_dtype[1]),
                        _port_of(j), out_dtype=x_dtype[1])
    assert _kernels.PLAIN_CALLS["K25"] == before + 1 and got.dtype == x_dtype[1]
    tol = TOL if x_dtype[1] == torch.float32 else 2.0 ** -8  # the one cast to bf16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_q8_matmul_layer_view_and_checks():
    w = torch.randn(3, 256, 130) * 0.05
    t = tq.quantize_q8(w)
    x = torch.randn(2, 4, 256)
    got = tmm.q8_matmul(x, t.layer(1))
    assert got.shape == (2, 4, 130)
    torch.testing.assert_close(got, tmm.q8_matmul(x.reshape(8, 256), tq.quantize_q8(w[1])
                                                  ).reshape(2, 4, 130), rtol=0, atol=0)
    with pytest.raises(ValueError):  # the stacked tensor, not a layer
        tmm.q8_matmul(x, t)
    with pytest.raises(ValueError):
        tmm.q8_matmul(torch.randn(4, 100), t.layer(0))
    with pytest.raises(TypeError):
        tmm.q8_matmul(x.half(), t.layer(0))


@pytest.mark.parametrize("quantize_wcls", [True, False])
def test_quantize_params_q8_tree_matches_jax(quantize_wcls):
    raw = make_random_weights(JaxModelConfig(**TINY_GQA), seed=11)
    dense = jl.fuse_projections(jl.params_from_raw(raw))
    jp = jl.quantize_params(dense, quantize_wcls=quantize_wcls)  # JAX's default: q8_0
    tp = tl.quantize_params(tl.fuse_projections(
        tl.params_from_raw(convert.raw_weights_from(raw), device="cpu")),
        quantize_wcls=quantize_wcls)
    via = convert.params_from_numpy(
        convert.params_to_numpy(tp), device="cpu")  # the port's own round trip
    for name in ("wq", "wo", "w1", "w2"):
        _assert_same(getattr(tp.layers, name), getattr(jp.layers, name))
        _assert_same(getattr(via.layers, name), getattr(jp.layers, name))
    for name in ("wk", "wv", "w3"):
        assert getattr(tp.layers, name).shape == (2, 1, 1)
    if quantize_wcls:
        _assert_same(tp.wcls, jp.wcls)
    else:
        np.testing.assert_array_equal(tp.wcls.numpy(), np.asarray(jp.wcls))
    assert tp.layers.wq.group_size == 16  # 48 inputs: the least padding


def test_random_quant_params_q8_shapes():
    cfg = ModelConfig(**TINY_GQA)
    t = tl.random_quant_params(cfg, mode="q8_0", seed=2, fuse=True, device="cpu")
    j = jl.random_quant_params(JaxModelConfig(**TINY_GQA), mode="q8_0", seed=2, fuse=True)
    for name in ("wq", "wo", "w1", "w2"):
        a, b = getattr(t.layers, name), getattr(j.layers, name)
        assert a.q.shape == tuple(np.swapaxes(np.asarray(b.q), -1, -2).shape)
        assert a.s.shape == tuple(np.swapaxes(np.asarray(b.s), -1, -2).shape)
        assert (a.logical_in, a.logical_out) == (b.logical_in, b.logical_out)
    assert t.wcls.q.shape == (384, 128) and float(t.wcls.s[0, 0]) == pytest.approx(2e-4)
    assert torch.equal(t.layers.w2.q, tl.random_quant_params(cfg, mode="q8_0", seed=2,
                                                             fuse=True, device="cpu").layers.w2.q)
    with pytest.raises(NotImplementedError):
        tl.random_quant_params(cfg, mode="w4a8", device="cpu")
    with pytest.raises(ValueError):
        tl.quantize_params(t, mode="q4")
    assert dataclasses.is_dataclass(t.layers.wq)

"""Port parity of K29, the resident-x W8A8 rows kernel: its plain version
against the JAX package's ``_w8a8_rows_resident_call`` run in interpret
mode, with the block sizes ``w8a8_matmul_prequant`` picks for it above 256
rows with ``TPU_LLAMA_ROWS_RESIDENT=1`` -- and the route itself.

The JAX side calls the kernel, not the jitted ``w8a8_matmul_prequant``:
that function reads the switch when it traces, and a trace of the same
case made earlier in the process with the switch off survives its
``_clear_cache()``.  tests/test_quant.py::test_w8a8_rows_resident_matches_
default makes exactly that trace (bf16 output with a residual), so where
pytest-xdist ran it first in the same worker the switched call returned the
default K1 path's [2048, 384] padded rows and the bf16-with-residual case
failed on its shape.

Limits.  K29 computes K1's function (exact int32 sums, the epilogue
``(f32(acc) * sx) * sw``, one cast, the residual added after it), so its
plain version is K1's and the results are byte-equal to JAX's in bf16 with
and without the residual (JAX's own case) and in f32 without it.  An f32
output with a residual is within 2^-22 of max |value| of JAX's: XLA on the
CPU contracts the interpreted ``r + acc * sx * sw`` into an FMA, where the
port rounds the product before the add (a few f32 ulps of the largest
entries).  The admission taken through K29 equals the default one bit for
bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_llama.ops import matmul as jm
from tpu_llama.ops import quant as jq
from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import matmul as tm
from tpu_llama_torch.ops import quant as tq

torch.set_num_threads(1)

SWITCH = "TPU_LLAMA_ROWS_RESIDENT"


def _case(M=512, IN=256, OUT=384, seed=41):
    """tests/test_quant.py::test_w8a8_rows_resident_matches_default's case."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(IN, OUT)).astype(np.float32) * 0.05
    xq = rng.integers(-127, 128, (M, IN)).astype(np.int8)
    sx = rng.uniform(0.01, 0.1, (M,)).astype(np.float32)
    r = np.asarray(jnp.asarray(rng.normal(size=(M, OUT)).astype(np.float32))
                   .astype(jnp.bfloat16).astype(jnp.float32))
    return w, xq, sx, r


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dt", [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)],
                         ids=["bf16", "f32"])
def test_k29_plain_equals_jax_rows_resident(monkeypatch, dt, residual):
    w, xq, sx, r = _case()
    M, IN = xq.shape
    wq = jq.quantize_channel(jnp.asarray(w))
    # the pick w8a8_matmul_prequant makes above 256 rows with the switch
    # set (matmul.py:516-523), then the kernel call it makes: not the jitted
    # function, whose trace of this case can outlive _clear_cache (see the
    # module docstring)
    pick = jm._pick_rows_resident(M, IN, wq.padded_out, jnp.dtype(dt[0]).itemsize,
                                  jnp.dtype(dt[0]).itemsize if residual else 0)
    assert pick is not None
    want = jm._w8a8_rows_resident_call(
        jnp.asarray(xq), jnp.asarray(sx), wq, dt[0], *pick,
        residual=jnp.asarray(r).astype(dt[0]) if residual else None)
    monkeypatch.setenv(SWITCH, "1")
    _kernels.reset_counts()
    got = tm.w8a8_matmul_prequant(torch.tensor(xq), torch.tensor(sx),
                                  tq.quantize_channel(torch.tensor(w)), out_dtype=dt[1],
                                  residual=torch.tensor(r).to(dt[1]) if residual else None)
    assert _kernels.PLAIN_CALLS["K29"] == 1 and _kernels.PLAIN_CALLS["K1"] == 0
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if residual and dt[1] == torch.float32:  # XLA's FMA: see the docstring
        assert np.abs(got - want).max() <= 2.0 ** -22 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


def test_k29_route(monkeypatch):
    """K29 is taken above 256 rows with the switch set, read at each call,
    for an inner size it holds (a multiple of 16 up to 12288: 32 rows a
    block up to 6144, where two 16 KB weight stages still fit beside the
    slice, else 16); K1 otherwise."""
    sizes = (4096, 11008, 5952, 5968, 11904, 11920, 200, 6144, 6160, 12288, 12304)
    assert [tm.rows_resident_bm(n) for n in sizes] == [32, 16, 32, 32, 16, 16, 0, 32, 16, 16, 0]
    w = tq.ChannelQuantTensor(q=torch.ones(8, 256, dtype=torch.int8), s=torch.ones(8))

    def run(m, n_in=256):
        wq = w if n_in == 256 else tq.ChannelQuantTensor(q=torch.ones(8, n_in, dtype=torch.int8),
                                                         s=torch.ones(8))
        _kernels.reset_counts()
        tm.w8a8_matmul_prequant(torch.ones(m, n_in, dtype=torch.int8), torch.ones(m), wq)
        return _kernels.PLAIN_CALLS["K29"], _kernels.PLAIN_CALLS["K1"]

    monkeypatch.delenv(SWITCH, raising=False)
    assert run(512) == (0, 1)
    monkeypatch.setenv(SWITCH, "1")
    assert run(512) == (1, 0) and run(256) == (0, 1) and run(300, 200) == (0, 1)
    monkeypatch.setenv(SWITCH, "0")
    assert run(512) == (0, 1)


def test_admission_through_k29_equals_default(monkeypatch):
    """A fused W8A8 admission of 2 x 160 rows (its products above 256 rows)
    with the switch set and then cleared: the same logits and cache, bit for
    bit, with every product of the switched run on K29."""
    cfg = ModelConfig(dim=256, hidden_dim=384, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=128, seq_len=256)
    params = tl.random_quant_params(cfg, seed=3, fuse=True, device="cpu",
                                    norm_dtype=torch.float32)
    B, T = 2, 160
    toks = torch.tensor(np.random.default_rng(4).integers(3, 128, (B, T)))
    out = {}
    for switch in ("1", "0"):
        monkeypatch.setenv(SWITCH, switch)
        cache = tl.make_kv_cache(cfg, B, kv_dtype="int8", seq_len=T, device="cpu")
        _kernels.reset_counts()
        logits, _ = tl.forward_prefill(params, cache, toks, torch.zeros(B, dtype=torch.int32),
                                       torch.tensor([T, 100]), cfg, logits_mode="all",
                                       assume_fresh=True)
        out[switch] = (logits, cache, dict(_kernels.PLAIN_CALLS))
    (l1, c1, n1), (l0, c0, n0) = out["1"], out["0"]
    assert torch.equal(l1, l0)
    for name in ("k", "v", "ks", "vs"):
        assert torch.equal(getattr(c1, name), getattr(c0, name))
    # per layer the qkv, wo, w13 and w2 products of 320 rows; the classifier's too
    assert n1["K29"] == 4 * cfg.n_layers + 1 and n0["K29"] == 0
    assert n1["K1"] == 0 and n0["K1"] == n1["K29"]

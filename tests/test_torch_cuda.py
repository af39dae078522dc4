"""Card tests: each CUDA kernel against its plain PyTorch version on the card.

Marked ``cuda``; they skip (inside the ``card`` fixture, never at import)
where there is no CUDA device.  Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.

Required agreement: K1, K2 and K7 exact.  K6 computes in f32 like its plain
version but sums in another order and uses CUDA's expf: f32 outputs within
1e-5 of the largest output, bf16 outputs within one bf16 rounding step of
it (2^-7 relative) plus that noise.
"""

import numpy as np
import pytest
import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import matmul as tm
from tpu_llama_torch.ops import quant as tq

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("m,n", [(1, 7), (5, 4096), (33, 11008), (3, 100), (64, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_exact(card, m, n, dtype):
    x = (torch.randn(m, n, generator=_gen(m * n), device=card) * 3).to(dtype)
    x[0] = 0
    before = _kernels.LAUNCHES["K2"]
    q, s = tq.quantize_activations(x)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K2"] == before + 1
    qp, sp = tq.quantize_activations_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (8, 4096, 4096), (8, 4096, 11008),
                                   (17, 40, 50), (200, 11008, 384), (300, 4096, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_exact(card, m, k, n, dtype):
    g = _gen(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=card) * 0.1
    w = tq.ChannelQuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
        s=torch.rand(n, generator=g, device=card) * 1e-3)
    got = tm.w8a8_matmul_prequant(xq, sx, w, out_dtype=dtype)
    torch.cuda.synchronize()
    want = tm.w8a8_matmul_prequant_plain(xq, sx, w, out_dtype=dtype)
    assert torch.equal(got, want)


def _k6_case(B, T, NH, KVH, S, hd, start, qdtype):
    g = _gen(B * T + S + hd)
    q = torch.randn(B, T, NH, hd, generator=g, device="cuda").to(qdtype)
    k = torch.randint(-127, 128, (B, KVH, S, hd), generator=g, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (B, KVH, S, hd), generator=g, device="cuda", dtype=torch.int8)
    ks = torch.rand(B, KVH, S, generator=g, device="cuda") * 0.02 + 0.005
    vs = torch.rand(B, KVH, S, generator=g, device="cuda") * 0.02 + 0.005
    return q, k, v, torch.tensor(start, dtype=torch.int32, device="cuda"), ks, vs


@pytest.mark.parametrize("case", [
    (2, 16, 4, 2, 16, 16, [0, 0]),
    (1, 130, 8, 2, 200, 64, [0]),
    (3, 40, 4, 4, 300, 128, [0, 17, 250]),
    (2, 512, 4, 4, 512, 128, [0, 0]),
    (1, 7, 6, 3, 9, 12, [2]),
])
@pytest.mark.parametrize("qdtype,odtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
def test_k6_close(card, case, qdtype, odtype):
    args = _k6_case(*case, qdtype)
    got = tatt.flash_prefill_attention(*args, out_dtype=odtype)
    torch.cuda.synchronize()
    want = tatt.flash_prefill_attention_plain(*args, out_dtype=odtype)
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    tol = 1e-5 * peak if odtype == torch.float32 else (2 ** -7 + 1e-5) * peak
    assert err <= tol, (err, peak)


@pytest.mark.parametrize("T,S,hd,slots", [(512, 2048, 128, [3, 0, 7]), (16, 64, 12, [1]),
                                          (128, 128, 64, [0, 1])])
def test_k7_exact(card, T, S, hd, slots):
    g = _gen(T + S)
    L, KVH, B = 3, 2, 8
    n = len(slots)

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=card, dtype=torch.int8)

    def rf(*shape):
        return torch.rand(shape, generator=g, device=card)

    small = (ri(L, n, KVH, T, hd), ri(L, n, KVH, T, hd), rf(L, n, KVH, T), rf(L, n, KVH, T))
    cache = (ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd), rf(L, B, KVH, S), rf(L, B, KVH, S))
    ref = [c.clone() for c in cache]
    sl = torch.tensor(slots, device=card)
    tatt.kv_cache_scatter_slots(small[0], small[1], sl, cache[0], cache[1], small[2],
                                small[3], cache[2], cache[3])
    torch.cuda.synchronize()
    tatt.kv_cache_scatter_slots_plain(small[0], small[1], slots, ref[0], ref[1], small[2],
                                      small[3], ref[2], ref[3])
    for a, b in zip(cache, ref):
        assert torch.equal(a, b)


def test_engine_card_matches_cpu(card):
    """A tiny f32-activation engine: greedy tokens on the card (kernels) equal
    the CPU's (plain versions)."""
    from tpu_llama_torch import convert
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=512, seq_len=256)
    cpu = tl.random_quant_params(cfg, seed=1, norm_dtype=torch.float32, device="cpu")
    gpu = convert.params_from_numpy(convert.params_to_numpy(cpu), device=card)
    out = []
    for params, dev in ((cpu, "cpu"), (gpu, card)):
        _kernels.reset_counts()
        b = ContinuousBatcher(Engine(params, cfg, max_batch=4, device=dev))
        reqs = [Request(prompt_tokens=list(range(3, 3 + n)), steps=n + 12, temperature=0.0)
                for n in (5, 130, 40)]
        for r in reqs:
            b.submit(r)
        b.run()
        out.append([r.out_tokens for r in reqs])
        if dev == card:
            assert all(_kernels.LAUNCHES[k] > 0 for k in _kernels.KERNELS)
            assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
    assert out[0] == out[1]

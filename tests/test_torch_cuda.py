"""Card tests: each CUDA kernel against its plain PyTorch version on the card.

Marked ``cuda``; they skip (inside the ``card`` fixture, never at import)
where there is no CUDA device.  Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.

Required agreement: K1 (with and without a residual, and its int32 form),
K2, K7, K10 and K18 exact; the device sampler's random bits and tokens equal the CPU's.  K3, K4 and K5 repeat their plain versions' f32 steps with
round-to-nearest intrinsics; K3 sums its squares in f64 and K4 calls CUDA's
expf as PyTorch's sigmoid does, so an exact sum on an f32 rounding boundary
or another expf could move a scale by an ulp and an int8 by one step:
int8 within one step on at most 1e-4 of entries, scales within 2^-21 (in
practice they are equal).  K6's INT8 form and K16 round q and
p * vs to bf16 before bf16 tensor-core dots, at their plain versions'
points and over the same 64-key tiles, but sum in another order and take
exp as the hardware's exp2, so a p * vs on a bf16 rounding boundary may
round the other way: within one bf16 step of the largest output (2^-7
relative) plus f32 noise, for f32 and bf16 outputs alike (K6_TOL,
chip_smoke.py's limit).  K6's fp forms compute the f32 dots of their plain
versions as sums of exact split products on the tensor cores (bf16 terms
for a bf16 cache, TF32 terms for an f32 one; csrc/prefill_split.cuh), sum
in another order and take exp as exp2: f32 outputs within 1e-5 of the
largest output.  K9 and K19 round q and p to
bf16 at the same places as their plain versions; the f32 sums run in
another order, which can flip a rare bf16 rounding of p: within one bf16
step (2^-7) of the largest output plus f32 noise, as K6 in bf16.  K9 and
K13 hold to the same limits at every count of key-row splits, against their
plain versions at that count; K20 and K22 (whole pages as the rounding
block, runs of pages in parallel) at every count of runs.
"""

import numpy as np
import pytest
import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import fused_layer as tfl
from tpu_llama_torch.ops import fused_step2 as tfs
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


# K2's and K3's edges (csrc/row_quant.cuh): one warp a row up to 4096 rows
# at N 4096, rows split over the warps of a block (11008, 12000), a few rows
# (whole blocks a row), bf16 rows that load as vectors while the int8 rows
# are not 16-byte aligned (4104), rows that load element by element (7,
# 100, and x at an odd storage offset: offset 1).  Row 0 is zero; the last
# row holds its absmax twice (with both signs); K2's row 1 (m > 2) has
# scale 1 and values on .5 ties, which round half to even.
RQ_CASES = [(1, 7, 0), (5, 4096, 0), (33, 11008, 0), (3, 100, 0), (64, 4096, 0),
            (1, 4096, 0), (8, 4096, 0), (32, 4096, 0), (1000, 4096, 0), (2048, 4096, 0),
            (4096, 4096, 0), (1, 11008, 0), (5, 12000, 0), (3, 4104, 0), (4096, 4104, 0),
            (1, 100, 0), (5, 4096, 1), (3, 100, 1), (33, 11008, 1)]


def _rq_rows(m, n, dtype, offset, seed, ties=False):
    g = _gen(seed)
    base = torch.randn(m * n + offset, generator=g, device="cuda") * 3
    if m > 1:
        row = base[offset + (m - 1) * n:offset + m * n]
        peak = row.abs().max() + 1
        row[n // 3], row[-1] = -peak, peak
    base[offset:offset + n] = 0
    if ties and m > 2:
        vals = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 3.5, -3.5],
                            device="cuda")
        base[offset + n:offset + n + min(n, 10)] = vals[:min(n, 10)]
        base[offset + n + min(n, 10):offset + 2 * n] = 0.25
    x = base.to(dtype)[offset:].view(m, n)
    assert offset == 0 or x.data_ptr() % 16
    return x


@pytest.mark.parametrize("m,n,offset", RQ_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_exact(card, m, n, offset, dtype):
    x = _rq_rows(m, n, dtype, offset, m * n, ties=True)
    before = _kernels.LAUNCHES["K2"]
    q, s = tq.quantize_activations(x)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K2"] == before + 1
    qp, sp = tq.quantize_activations_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    if m > 2 and n >= 10:
        assert s[1] == 1 and q[1, :10].tolist() == [127, 0, 2, 2, 0, -2, 126, -126, 4, -4][:n]


# K1's tile edges: the decode tile up to 16 rows; above, the wgmma tile's
# 64-row consumer halves (63, 65), its 128-row blocks (129), the prefix
# continuation (1000), a chunk (2048) and the admission (4096); columns
# ragged against 256 (136, 4000); K a multiple of 16 but not of 128 (4112),
# K padded to 16 by the wrapper (40), K inside one 128-byte stage (96); and
# the Llama-2 7B products at M 4096.
K1_7B = [(4096, 4096, 4096), (4096, 4096, 11008), (4096, 11008, 4096), (4096, 4096, 32000),
         (4096, 4096, 12288), (4096, 4096, 22016)]


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (8, 4096, 4096), (8, 4096, 11008),
                                   (17, 40, 50), (200, 11008, 384), (300, 4096, 136),
                                   (17, 4096, 4000), (63, 96, 136), (65, 4112, 256),
                                   (129, 4112, 4000), (33, 40, 136), (1000, 4096, 12288),
                                   (2048, 11008, 4096), (4096, 96, 4000)] + K1_7B)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_exact(card, m, k, n, dtype):
    g = _gen(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=card) * 0.1
    w = tq.ChannelQuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
        s=torch.rand(n, generator=g, device=card) * 1e-3)
    before = _kernels.LAUNCHES["K1"]
    got = tm.w8a8_matmul_prequant(xq, sx, w, out_dtype=dtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K1"] == before + 1
    want = tm.w8a8_matmul_prequant_plain(xq, sx, w, out_dtype=dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (200, 11008, 384), (300, 96, 136),
                                   (17, 40, 50), (63, 4112, 4000), (65, 96, 136),
                                   (129, 40, 4000), (1000, 4096, 4096), (2048, 11008, 4096),
                                   (4096, 4096, 4096), (4096, 11008, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_residual_exact(card, m, k, n, dtype):
    g = _gen(m * 3 + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=card) * 0.1
    w = tq.ChannelQuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
        s=torch.rand(n, generator=g, device=card) * 1e-3)
    r = (torch.randn(m, n, generator=g, device=card) * 4).to(dtype)
    before = _kernels.LAUNCHES["K1"]
    got = tm.w8a8_matmul_prequant(xq, sx, w, out_dtype=dtype, residual=r)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K1"] == before + 1
    want = tm.w8a8_matmul_prequant_plain(xq, sx, w, out_dtype=dtype, residual=r)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 4096), (8, 5504, 4096), (1, 100, 50),
                                   (5, 40, 33), (16, 4096, 4096), (17, 2048, 4096),
                                   (300, 96, 136), (1024, 2048, 4096), (1024, 5504, 4096),
                                   (63, 4112, 4000)])
def test_k1_int32_exact(card, m, k, n):
    """K1's int32 form (the decode tile up to 16 rows, the wgmma form above,
    byte loads where K % 16 != 0) equals its plain version's exact sums."""
    g = _gen(m + 7 * k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w = tq.ChannelQuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
        s=torch.rand(n, generator=g, device=card) * 1e-3)
    before = _kernels.LAUNCHES["K1:i32"]
    got = tm.w8a8_matmul_int32(xq, w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K1:i32"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, tm.w8a8_matmul_int32_plain(xq, w))


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (8, 11008, 4096), (1024, 4096, 4096),
                                   (33, 11008, 4096)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_int32_slices_then_epilogue_equal_k1(card, m, k, n, dtype):
    """The sharded engine's row-sharded product on the card: K1's int32
    form on two halves of K, the sums added, ``w8a8_epilogue`` with the
    residual -- K1 with its residual epilogue on the whole K, bit for bit
    (the epilogue's PyTorch steps round as the kernel's)."""
    g = _gen(m * 5 + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=card) * 0.1
    w = tq.ChannelQuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
        s=torch.rand(n, generator=g, device=card) * 1e-3)
    r = (torch.randn(m, n, generator=g, device=card) * 4).to(dtype)
    h = k // 2
    acc = sum(tm.w8a8_matmul_int32(xq[:, a:b].contiguous(),
                                   tq.ChannelQuantTensor(q=w.q[:, a:b].contiguous(), s=w.s))
              for a, b in ((0, h), (h, k)))
    got = tm.w8a8_epilogue(acc, sx, w.s, dtype, r)
    want = tm.w8a8_matmul_prequant(xq, sx, w, out_dtype=dtype, residual=r)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _quant_close(q, qp, s, sp):
    d = (q.int() - qp.int()).abs()
    assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-4
    torch.testing.assert_close(s, sp, rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("m,n,offset", RQ_CASES + [(64, 12000, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_close(card, m, n, offset, dtype):
    x = _rq_rows(m, n, dtype, offset, m * n + 3)
    w = (1 + 0.2 * torch.randn(n, generator=_gen(m * n + 4), device=card)).to(dtype)
    before = _kernels.LAUNCHES["K3"]
    q, s = tq.rmsnorm_quantize(x, w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K3"] == before + 1
    qp, sp = tq.rmsnorm_quantize_plain(x, w)
    _quant_close(q, qp, s, sp)
    assert s[0] == 0 and not q[0].any()


# w in another dtype than x: mega2's prologue runs f32 x (the embedding rows)
# with the served bf16 norm weights, whose reads take their own vector width
@pytest.mark.parametrize("m,n,offset", RQ_CASES + [(64, 12000, 0)])
@pytest.mark.parametrize("dtype,w_dtype", [(torch.float32, torch.bfloat16),
                                           (torch.bfloat16, torch.float32)])
def test_k3_close_mixed_dtypes(card, m, n, offset, dtype, w_dtype):
    x = _rq_rows(m, n, dtype, offset, m * n + 5)
    w = 1 + 0.2 * torch.randn(n, generator=_gen(m * n + 6), device=card)
    w = w.to(w_dtype)
    assert not torch.all(w == 1)
    before = _kernels.LAUNCHES["K3"]
    q, s = tq.rmsnorm_quantize(x, w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K3"] == before + 1
    qp, sp = tq.rmsnorm_quantize_plain(x, w)
    _quant_close(q, qp, s, sp)
    assert s[0] == 0 and not q[0].any()


@pytest.mark.parametrize("m,h", [(1, 7), (5, 11008), (33, 256), (3, 100), (8, 12000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_close_on_strided_halves(card, m, h, dtype):
    g = _gen(m * h + 4)
    gu = (torch.randn(m, 2 * h, generator=g, device=card) * 4).to(dtype)
    gu[0] = 0
    gate, up = gu[:, :h], gu[:, h:]
    before = _kernels.LAUNCHES["K4"]
    q, s = tq.silu_mul_quantize(gate, up)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K4"] == before + 1
    qp, sp = tq.silu_mul_quantize_plain(gate, up)
    _quant_close(q, qp, s, sp)


@pytest.mark.parametrize("NH,KVH,hd", [(4, 4, 128), (8, 2, 128), (3, 1, 64), (2, 2, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("into_cache", [False, True])
def test_k5_close(card, NH, KVH, hd, dtype, into_cache):
    B, T, S = 3, 40, 48
    M, D = B * T, NH * hd
    g = _gen(NH * KVH + hd)
    qkv = (torch.randn(M, D + 2 * KVH * hd, generator=g, device=card) * 3).to(dtype)
    ang = torch.rand(M, hd // 2, generator=g, device=card) * 6.3
    cos, sin = ang.cos(), ang.sin()
    out = out_p = None
    if into_cache:  # the layer's block of a head-major cache, in place
        caches = [torch.zeros(B, KVH, S, *d, dtype=t, device=card)
                  for t, d in [(torch.int8, (hd,)), (torch.float32, ())] * 2]  # k, ks, v, vs
        caches_p = [c.clone() for c in caches]
        out = [c[:, :, :T].transpose(1, 2) for c in caches]
        out_p = [c[:, :, :T].transpose(1, 2) for c in caches_p]
    before = _kernels.LAUNCHES["K5"]
    got = tq.rope_split_quantize(qkv, cos, sin, D, KVH, hd, out=out)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K5"] == before + 1
    want = tq.rope_split_quantize_plain(qkv, cos, sin, D, KVH, hd, out=out_p)
    assert torch.equal(got[0], want[0])
    _quant_close(got[1], want[1], got[2], want[2])
    _quant_close(got[3], want[3], got[4], want[4])
    if into_cache:
        for c, cp in zip(caches, caches_p):
            assert torch.equal(c, cp)


K6_TOL = 2.0 ** -7 + 1e-5  # of max |plain|: one bf16 step + f32 noise


def _k6_case(B, T, NH, KVH, S, hd, start, qdtype):
    g = _gen(B * T + S + hd)
    q = torch.randn(B, T, NH, hd, generator=g, device="cuda").to(qdtype)
    k = torch.randint(-127, 128, (B, KVH, S, hd), generator=g, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (B, KVH, S, hd), generator=g, device="cuda", dtype=torch.int8)
    ks = torch.rand(B, KVH, S, generator=g, device="cuda") * 0.02 + 0.005
    vs = torch.rand(B, KVH, S, generator=g, device="cuda") * 0.02 + 0.005
    for b, s0 in enumerate(start):  # poison the rows no query attends
        for a, val in ((k, 127), (v, 127), (ks, 1e4), (vs, 1e4)):
            a[b, :, s0 + T:] = val
    return q, k, v, torch.tensor(start, dtype=torch.int32, device="cuda"), ks, vs


@pytest.mark.parametrize("case", [
    (2, 16, 4, 2, 16, 16, [0, 0]),
    (1, 130, 8, 2, 200, 64, [0]),
    (3, 40, 4, 4, 300, 128, [0, 17, 250]),
    (2, 512, 4, 4, 512, 128, [0, 0]),
    (1, 7, 6, 3, 9, 12, [2]),
    (2, 77, 8, 1, 400, 128, [0, 100]),    # G 8, ragged T, a start off the 64-key tiles
    (1, 200, 16, 4, 1000, 128, [700]),    # G 4, several q tiles past a long prefix
])
@pytest.mark.parametrize("qdtype,odtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
def test_k6_close(card, case, qdtype, odtype):
    args = _k6_case(*case, qdtype)
    before = _kernels.LAUNCHES["K6"]
    got = tatt.flash_prefill_attention(*args, out_dtype=odtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K6"] == before + 1
    want = tatt.flash_prefill_attention_plain(*args, out_dtype=odtype)
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    assert err <= K6_TOL * peak, (err, peak)


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


DECODE_TOL = 2 ** -7 + 1e-5  # of max |plain|


def _decode_case(B, KVH, G, hd, S, pos, qdtype, L=3):
    g = _gen(B * KVH + G + hd + S)

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, device="cuda", dtype=torch.int8)

    def rs(*shape):
        return torch.rand(shape, generator=g, device="cuda") * 0.02 + 0.005

    q = torch.randn(B, KVH, G, hd, generator=g, device="cuda").to(qdtype)
    return (q, ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd),
            torch.tensor(pos, dtype=torch.int32, device="cuda"), ri(B, KVH, hd),
            ri(B, KVH, hd), rs(L, B, KVH, S), rs(L, B, KVH, S), rs(B, KVH), rs(B, KVH))


@pytest.mark.parametrize("G,hd", [(1, 64), (4, 64), (1, 128), (4, 128), (2, 12)])
@pytest.mark.parametrize("kernel,name,kw", [("K9", "dma", {}), ("K9", "dma", {"block_s": 64}),
                                            ("K19", "fresh", {})])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_decode_attention_close(card, G, hd, kernel, name, kw, qdtype):
    S = 512
    args = _decode_case(4, 3, G, hd, S, [0, 1, 300, S - 1], qdtype)
    before = _kernels.LAUNCHES[kernel]
    got = getattr(tatt, f"flash_decode_attention_{name}")(*args, layer=1, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[kernel] == before + 1
    want = getattr(tatt, f"flash_decode_attention_{name}_plain")(*args, layer=1, **kw)
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert err <= DECODE_TOL * peak, (err, peak)


@pytest.mark.parametrize("hd", [128, 64, 12])
def test_k10_exact_and_skips_out_of_range(card, hd):
    g = _gen(hd)
    L, B, KVH, S = 3, 5, 4, 256

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=card, dtype=torch.int8)

    def rf(*shape):
        return torch.rand(shape, generator=g, device=card)

    rows = (ri(L, B, KVH, hd), ri(L, B, KVH, hd), rf(L, B, KVH), rf(L, B, KVH))
    cache = (ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd), rf(L, B, KVH, S), rf(L, B, KVH, S))
    before = [c.clone() for c in cache]
    ref = [c.clone() for c in cache]
    pos = torch.tensor([0, S - 1, 8, S, -1], dtype=torch.int32, device=card)
    tatt.kv_cache_flush_rows(rows[0], rows[1], pos, cache[0], cache[1], rows[2], rows[3],
                             cache[2], cache[3])
    torch.cuda.synchronize()
    tatt.kv_cache_flush_rows_plain(rows[0], rows[1], pos, ref[0], ref[1], rows[2], rows[3],
                                   ref[2], ref[3])
    for a, b, c in zip(cache, ref, before):
        assert torch.equal(a, b)
        assert torch.equal(a[:, 3:], c[:, 3:])  # slots at pos S and -1 untouched


@pytest.mark.parametrize("B,KVH,Tc,hd,S,start,stacked", [
    (2, 3, 256, 128, 1024, 512, True), (1, 2, 100, 64, 300, 199, True),
    (3, 1, 7, 12, 40, 33, False), (2, 2, 64, 128, 64, 0, False)])
def test_k18_exact(card, B, KVH, Tc, hd, S, start, stacked):
    """Bit-equal (a copy); rows outside [start, start + Tc) untouched."""
    g = _gen(B + KVH + Tc + hd + S)
    lead = (3,) if stacked else ()
    layer = 2 if stacked else 0

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=card, dtype=torch.int8)

    def rf(*shape):
        return torch.rand(shape, generator=g, device=card)

    rows = (ri(B, KVH, Tc, hd), ri(B, KVH, Tc, hd), rf(B, KVH, Tc), rf(B, KVH, Tc))
    cache = (ri(*lead, B, KVH, S, hd), ri(*lead, B, KVH, S, hd), rf(*lead, B, KVH, S),
             rf(*lead, B, KVH, S))
    ref = [c.clone() for c in cache]
    before = _kernels.LAUNCHES["K18"]
    tatt.kv_cache_write_chunk(*rows, start, layer, *cache)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K18"] == before + 1
    tatt.kv_cache_write_chunk_plain(*rows, start, layer,
                                    *[r if stacked else r[None] for r in ref])
    for a, b in zip(cache, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("V", [32000, 517])
def test_sampler_card_equals_cpu(card, V):
    """The threefry bits are integer arithmetic: equal on both devices.  The
    sampled tokens too, on these seeds (softmax and masked sums in another
    order could part them only at a cutoff tie)."""
    from tpu_llama_torch.ops import sampling as ts

    rng = np.random.default_rng(V)
    x = (rng.standard_normal((8, V)) * 3).astype(np.float32)
    keys = ts.fold_in(torch.tensor(ts.keys_numpy(range(8))), torch.arange(8) * 100)
    temps = torch.tensor([0.0, 0.8, 1.3, 0.8, 1.3, 0.8, 0.0, 1.0])
    topps = torch.tensor([1.0, 0.9, 1.0, 1.0, 0.9, 0.9, 1.0, 0.95])
    topks = torch.tensor([0, 0, 40, 40, 0, 40, 0, 0])
    u_cpu = ts.uniform(keys, (V,), 1e-20, 1.0)
    u_card = ts.uniform(keys.to(card), (V,), 1e-20, 1.0)
    assert torch.equal(u_card.cpu().view(torch.int32), u_cpu.view(torch.int32))
    for fn in (ts.sample, ts.sample_nosort):
        cpu = fn(torch.tensor(x), keys, temps, topps, topks)
        got = fn(torch.tensor(x).to(card), keys.to(card), temps.to(card), topps.to(card),
                 topks.to(card))
        assert torch.equal(got.cpu(), cpu)


def _fused_case(B, KVH, G, hd, H, L=3, S=300, pos=None):
    """Random stacked fused-layer weights, rows and a cache on the card."""
    g = _gen(B * 7 + KVH + G + hd + H)
    D = KVH * G * hd
    QO = D + 2 * KVH * hd

    def qt(n_in, n_out):
        return tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=g, device="cuda",
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=g, device="cuda") * 2e-3 + 1e-3)

    w = (qt(D, D), qt(D, 2 * H), qt(H, D), qt(D, QO))
    rms = [(1 + 0.1 * torch.randn(L, D, generator=g, device="cuda")).to(torch.bfloat16)
           for _ in range(2)]
    x = torch.randn(B, D, generator=g, device="cuda")
    attq = torch.randint(-127, 128, (B, D), generator=g, device="cuda", dtype=torch.int8)
    satt = torch.rand(B, generator=g, device="cuda") * 0.02 + 0.005
    cache = (torch.randint(-127, 128, (L, B, KVH, S, hd), generator=g, device="cuda",
                           dtype=torch.int8),
             torch.randint(-127, 128, (L, B, KVH, S, hd), generator=g, device="cuda",
                           dtype=torch.int8),
             torch.rand(L, B, KVH, S, generator=g, device="cuda") * 0.02 + 0.005,
             torch.rand(L, B, KVH, S, generator=g, device="cuda") * 0.02 + 0.005)
    pos = pos or [(37 * b) % S for b in range(B - 1)] + [S - 1]
    ang = torch.rand(B, hd // 2, generator=g, device="cuda") * 6.3
    return dict(w=w, rms=rms, x=x, attq=attq, satt=satt, cache=cache, L=L, NH=KVH * G,
                pos=torch.tensor(pos, dtype=torch.int32, device="cuda"), cos=ang.cos(),
                sin=ang.sin())


@pytest.mark.parametrize("B", [1, 3, 8])
def test_k8_exact(card, B):
    c = _fused_case(B, 2, 2, 64, 192)
    wqkv = c["w"][3]
    xq = c["attq"]
    before = _kernels.LAUNCHES["K8"]
    for layer in range(c["L"]):
        got = tfl.w8a8_matmul_stacked(xq, c["satt"], wqkv, layer)
        torch.cuda.synchronize()
        assert torch.equal(got, tfl.w8a8_matmul_stacked_plain(xq, c["satt"], wqkv, layer))
    assert _kernels.LAUNCHES["K8"] == before + c["L"]


# K11's shapes: small ones (D 64 and 512, H 96 and 336, G 1-4; B 20 takes
# the four-tile form above 8 rows) and Llama-2 7B widths at batch 1, 8 and 32
K11_CASES = [(1, 2, 1, 128, 384), (3, 2, 4, 64, 336), (8, 4, 1, 64, 256), (20, 1, 2, 32, 96),
             (1, 32, 1, 128, 11008), (8, 32, 1, 128, 11008), (32, 32, 1, 128, 11008)]


@pytest.mark.parametrize("B,KVH,G,hd,H", K11_CASES)
def test_k11_exact(card, B, KVH, G, hd, H):
    """Bit-equal: the kernel repeats the plain version's f32 steps (CUDA's
    expf is PyTorch's exp on the card; h2 stays f32); the last layer leaves
    qkv alone.  Every layer of the stack (a middle one and the last), each
    launched twice on the stream's workspace, which the first launch must
    leave zero: the second launch equals the first."""
    c = _fused_case(B, KVH, G, hd, H)
    for layer in range(c["L"]):
        args = (c["x"], c["attq"], c["satt"], *c["w"], *c["rms"], layer, c["L"])
        bufs = [torch.full((B, c["w"][3].out_features), 7.0, device=card) for _ in range(2)]
        before = _kernels.LAUNCHES["K11"]
        x, qkv = tfl.fused_layer_linear(*args, qkv_out=bufs[0])
        x2, qkv2 = tfl.fused_layer_linear(*args, qkv_out=bufs[1])
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["K11"] == before + 2 and qkv is bufs[0] and qkv2 is bufs[1]
        assert torch.equal(x2, x) and torch.equal(qkv2, qkv)
        xp, qkvp = tfl.fused_layer_linear_plain(*args)
        assert torch.equal(x, xp)
        if layer + 1 < c["L"]:
            assert torch.equal(qkv, qkvp)
        else:
            assert (qkv == 7.0).all()


@pytest.mark.parametrize("B,KVH,G,hd,H", [(1, 2, 1, 128, 384), (3, 2, 4, 64, 336),
                                          (8, 4, 1, 64, 256), (3, 1, 2, 12, 96)])
def test_k12_close(card, B, KVH, G, hd, H):
    """x_next bit-equal; the fresh K/V rows bit-equal (the same RoPE and
    quant steps); the attention output, whose f32 sums run in another order
    (K9's tolerance, DECODE_TOL), within one int8 step on at most 1e-3 of
    entries, its row scales (absmax / 127) within DECODE_TOL relative and its
    dequantized values within DECODE_TOL of the largest.  The last layer
    computes x_next only."""
    c = _fused_case(B, KVH, G, hd, H)
    for layer in range(c["L"]):
        args = (c["x"], c["attq"], c["satt"], *c["cache"], c["pos"], c["cos"], c["sin"],
                *c["w"], *c["rms"], layer, c["L"], c["NH"])
        before = _kernels.LAUNCHES["K12"]
        got = tfs.fused_step2_layer(*args)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["K12"] == before + 1
        want = tfs.fused_step2_layer_plain(*args)
        assert torch.equal(got[0], want[0])
        if layer + 1 == c["L"]:
            continue
        for i in (3, 4, 5, 6):
            assert torch.equal(got[i], want[i])
        d = (got[1].int() - want[1].int()).abs()
        assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-3
        torch.testing.assert_close(got[2], want[2], rtol=DECODE_TOL, atol=0)
        att, att_p = (o[1].float() * o[2][:, None] for o in (got, want))
        assert (att - att_p).abs().max().item() <= DECODE_TOL * att_p.abs().max().item()


# Where the CPU's top two next-token log-probabilities are closer than this,
# the card may take the other token.  K9 and K19 round p * vs to bf16, so an
# f32 ulp of difference (CUDA's expf against PyTorch's exp, another order of
# sums) flips a rare bf16 rounding, and through the int8 activation quant
# that moves this model's logits by about 1e-3: on an H100, requiring equal
# tokens failed for K19 at a step where the CPU's top two were 1.1e-3 apart
# (PERF.md).
NEAR_TIE = 5e-3


@pytest.mark.parametrize("attn,fuse,fused", [("xla", False, False), ("flash", False, False),
                                             ("flash_dma", False, False),
                                             ("flash_dma", True, False), ("flash_dma", True, True),
                                             ("flash_dma", True, "mega2")])
def test_engine_card_matches_cpu(card, attn, fuse, fused):
    """A tiny f32-activation engine with the same explicit decode attention,
    fused decode and prefill attention ("flash": K6 on the card, its plain
    version on the CPU) on both sides: greedy tokens on the card (kernels)
    equal the CPU's (plain versions) -- exactly for the f32 xla attention;
    for the bf16-rounding K9, K19 and K12 up to the first step where the
    CPU's top two tokens are within NEAR_TIE, after which a stream is not
    compared.  ``fuse``: the fused layouts, whose prefill runs K3, K4 and
    K5; ``fused``: the two-launch (K8, K11) or mega2 (K8, K12) decode."""
    from tpu_llama_torch import convert
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=512, seq_len=256)
    cpu = tl.random_quant_params(cfg, seed=1, norm_dtype=torch.float32, fuse=fuse,
                                 device="cpu")
    gpu = convert.params_from_numpy(convert.params_to_numpy(cpu), device=card)
    out = []
    for params, dev in ((cpu, "cpu"), (gpu, card)):
        _kernels.reset_counts()
        b = ContinuousBatcher(Engine(params, cfg, kv_dtype="int8", max_batch=4, attn=attn,
                                     fused=fused, prefill_attn="flash", device=dev))
        reqs = [Request(prompt_tokens=list(range(3, 3 + n)), steps=n + 12, temperature=0.0,
                        logprobs=2) for n in (5, 130, 40)]
        for r in reqs:
            b.submit(r)
        b.run()
        out.append(reqs)
        if dev == card:  # every kernel of the path launched, and no other
            path = {"K1", "K2", "K6", "K7"} | {
                "flash": {"K19", "K10"}, "flash_dma": {"K9", "K10"}}.get(attn, set()) | (
                {"K3", "K4", "K5"} if fuse else set()) | (
                {"mega2": {"K8", "K12"}, True: {"K8", "K11"}}.get(fused, set()))
            assert {k for k, n in _kernels.LAUNCHES.items() if n > 0} == path
            assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
    for c, g in zip(*out):
        assert len(c.out_tokens) == 12
        part = next((i for i, (a, b) in enumerate(zip(c.out_tokens, g.out_tokens)) if a != b),
                    None)
        if attn == "xla" or part is None:
            assert g.out_tokens == c.out_tokens
        else:
            (_, top1), (_, top2) = c.out_top_logprobs[part][:2]
            assert top1 - top2 < NEAR_TIE, (attn, part, c.out_tokens, g.out_tokens)


# ---------------------------------------------------------------- K25 (Q8_0)
# K25 against its plain version: both multiply bf16(x) by the bf16 weights
# bf16(bf16(q) * bf16(s)), products exact in f32, sums in f32 in another
# order (the tensor cores' against the plain version's matmul): f32 outputs
# within 1e-4 of the largest output, bf16 outputs within one bf16 rounding
# step (2^-7) of it.


@pytest.mark.parametrize("m,k,n,g,stacked", [
    (8, 4096, 22016, None, False),    # the decode's w13 (g 64)
    (4096, 4096, 12288, None, False),  # the admission's wqkv
    (5, 200, 130, None, False),       # padded in (256) and out (256)
    (40, 11008, 4096, None, True),    # w2 (g 32) as a layer view of stacked weights
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k25_close(card, m, k, n, g, stacked, dtype):
    gen = _gen(m + k + n)
    w = torch.randn(2 if stacked else 1, k, n, generator=gen, device=card) * 0.05
    qt = tq.quantize_q8(w if stacked else w[0], g)
    wt = qt.layer(1) if stacked else qt
    x = torch.randn(m, k, generator=gen, device=card).to(dtype)
    before = _kernels.LAUNCHES["K25"]
    got = tm.q8_matmul(x, wt, out_dtype=dtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K25"] == before + 1 and got.shape == (m, n)
    want = tm.q8_matmul_plain(x, wt, out_dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


# K25's two kernels at their edges: the wgmma kernel (M > 16) at ragged M
# (17, 1000, 4095), an out-dim short of its padded 128-row tiles, in 11008
# (g 32) through a layer view of stacked weights, bf16 x and outputs; the
# decode kernel (M <= 16) at M 1 and 16.  Limits as above.


@pytest.mark.parametrize("m,k,n,pad,layers", [
    (17, 4096, 4096, None, 1),     # one m-tile, 17 of its 256 rows
    (1000, 11008, 4096, None, 3),  # g 32, the last layer of three
    (4095, 4096, 4000, 4096, 1),   # 4000 of 4096 padded out rows
    (300, 4096, 1000, 1024, 2),    # a layer view, 1000 of 1024
    (1, 4096, 12288, None, 1),     # decode kernel, one x row
    (16, 11008, 4096, None, 2),    # decode kernel, two x row tiles, g 32
    (9, 4096, 1000, 1024, 1),      # decode kernel, ragged rows and out
])
@pytest.mark.parametrize("xdtype,odtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.float32, torch.bfloat16)])
def test_k25_edges_close(card, m, k, n, pad, layers, xdtype, odtype):
    gen = _gen(m * 7 + k + n)
    g = tq.pick_group_size(k)
    rows = pad or n
    q = torch.randint(-127, 128, (layers, rows, k), generator=gen, device=card,
                      dtype=torch.int8)
    sc = torch.rand(layers, rows, k // g, generator=gen, device=card) * 1e-3 + 1e-4
    wt = tq.QuantTensor(q=q, s=sc, logical_in=k, logical_out=n).layer(layers - 1)
    x = torch.randn(m, k, generator=gen, device=card).to(xdtype)
    before = _kernels.LAUNCHES["K25"]
    got = tm.q8_matmul(x, wt, out_dtype=odtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K25"] == before + 1 and got.shape == (m, n)
    want = tm.q8_matmul_plain(x, wt, out_dtype=odtype)
    tol = 1e-4 if odtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


# ------------------------------------------------- the fp forms of K6-K19
# f32 throughout on both sides, nothing rounded: K6, K9 and K19 within 1e-5
# of the largest output (sum order and expf); K7 and K10 exact.  Queries in
# f32, as the dense and Q8_0 paths pass them, and in bf16 beside it.  The
# decode cases poison the rows at and past each slot's pos with 1e4: a
# kernel that read one would miss by orders of magnitude.

FP = [torch.float32, torch.bfloat16]


def _fp_decode_case(B, KVH, G, hd, S, pos, cdtype, qdtype, L=3):
    g = _gen(B * 100 + hd + G)
    q = torch.randn(B, KVH, G, hd, generator=g, device="cuda").to(qdtype)
    k, v = (torch.randn(L, B, KVH, S, hd, generator=g, device="cuda").to(cdtype)
            for _ in range(2))
    nk, nv = (torch.randn(B, KVH, hd, generator=g, device="cuda").to(cdtype) for _ in range(2))
    for b, p in enumerate(pos):
        k[:, b, :, p:] = 1e4
        v[:, b, :, p:] = 1e4
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda"), nk, nv


@pytest.mark.parametrize("G,hd", [(1, 128), (4, 64), (2, 12)])
@pytest.mark.parametrize("name", ["dma", "fresh"])
@pytest.mark.parametrize("cdtype", FP)
@pytest.mark.parametrize("qdtype", FP)
def test_fp_decode_attention_close(card, G, hd, name, cdtype, qdtype):
    args = _fp_decode_case(3, 2, G, hd, 256, [0, 77, 255], cdtype, qdtype)
    fn = getattr(tatt, f"flash_decode_attention_{name}")
    form = _kernels.form("K9" if name == "dma" else "K19", cdtype)
    before = _kernels.LAUNCHES[form]
    got = fn(*args, layer=1)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[form] == before + 1
    want = getattr(tatt, f"flash_decode_attention_{name}_plain")(*args, layer=1)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("B,T,NH,KVH,S,hd,start", [(2, 128, 4, 4, 128, 128, [0, 0]),
                                                   (2, 40, 8, 2, 256, 64, [0, 200]),
                                                   (1, 16, 4, 2, 64, 12, [30])])
@pytest.mark.parametrize("cdtype", FP)
@pytest.mark.parametrize("qdtype", FP)
def test_fp_k6_close(card, B, T, NH, KVH, S, hd, start, cdtype, qdtype):
    g = _gen(T + S + hd)
    q = torch.randn(B, T, NH, hd, generator=g, device=card).to(qdtype)
    k, v = (torch.randn(B, KVH, S, hd, generator=g, device=card).to(cdtype) for _ in range(2))
    st = torch.tensor(start, dtype=torch.int32, device=card)
    form = _kernels.form("K6", cdtype)
    before = _kernels.LAUNCHES[form]
    got = tatt.flash_prefill_attention(q, k, v, st)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[form] == before + 1
    want = tatt.flash_prefill_attention_plain(q, k, v, st)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# K6's fp forms on the split cells (csrc/prefill_split.cuh) at GQA G 4 (KVH
# 8), hd 64 and 128, starts past several 64-key tiles, both block widths
# (B 2 x KVH 8 x T 96 launches fewer blocks than the card has SMs: 4 warps a
# block; B 8 x T 256 more: 8 warps), f32 and bf16 queries; f32 outputs
# within 1e-5 of the peak, bf16 outputs within one bf16 step (K6_TOL).


@pytest.mark.parametrize("B,T,S,hd,start", [(2, 96, 512, 128, [0, 300]),
                                            (2, 96, 512, 64, [130, 333]),
                                            (8, 256, 1024, 128, [0, 64, 128, 200, 500, 700,
                                                                 768, 700])])
@pytest.mark.parametrize("cdtype", FP)
@pytest.mark.parametrize("qdtype,odtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.float32),
                                           (torch.float32, torch.bfloat16)])
def test_fp_k6_gqa_close(card, B, T, S, hd, start, cdtype, qdtype, odtype):
    NH, KVH = 32, 8
    g = _gen(B * T + S + hd)
    q = torch.randn(B, T, NH, hd, generator=g, device=card).to(qdtype)
    k, v = (torch.randn(B, KVH, S, hd, generator=g, device=card).to(cdtype) for _ in range(2))
    st = torch.tensor(start, dtype=torch.int32, device=card)
    form = _kernels.form("K6", cdtype)
    before = _kernels.LAUNCHES[form]
    got = tatt.flash_prefill_attention(q, k, v, st, out_dtype=odtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[form] == before + 1
    want = tatt.flash_prefill_attention_plain(q, k, v, st, out_dtype=odtype)
    tol = 1e-5 if odtype == torch.float32 else K6_TOL
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("hd", [128, 12])
@pytest.mark.parametrize("cdtype", FP)
def test_fp_k7_k10_exact(card, hd, cdtype):
    g = _gen(hd)
    L, n, KVH, T, B, S = 2, 2, 2, 64, 4, 128
    small = [torch.randn(L, n, KVH, T, hd, generator=g, device=card).to(cdtype)
             for _ in range(2)]
    cache = [torch.randn(L, B, KVH, S, hd, generator=g, device=card).to(cdtype)
             for _ in range(2)]
    ref = [c.clone() for c in cache]
    tatt.kv_cache_scatter_slots(*small, [3, 1], *cache)
    torch.cuda.synchronize()
    tatt.kv_cache_scatter_slots_plain(*small, [3, 1], *ref)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref))
    rows = [torch.randn(L, B, KVH, hd, generator=g, device=card).to(cdtype) for _ in range(2)]
    pos = torch.tensor([0, 5, S, 127], dtype=torch.int32, device=card)
    tatt.kv_cache_flush_rows(*rows, pos, *cache)
    torch.cuda.synchronize()
    tatt.kv_cache_flush_rows_plain(*rows, pos, *ref)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref))
    assert _kernels.LAUNCHES[_kernels.form("K7", cdtype)] > 0
    assert _kernels.LAUNCHES[_kernels.form("K10", cdtype)] > 0


# ------------------------------------------------- the paged kernels (K13, K14, K15, K20)
# K14 and K15 are copies: bit-equal to their plain versions outside the trash
# page 0 (several slots may write it at once).  K13 and K20 round as K9 (their
# plain versions' steps, f32 sums in another order): DECODE_TOL, on pools whose
# rows outside every slot's live range are poisoned.  K13 equals K9 bit for bit
# on a paged copy of a dense cache at K9's block_s = K13's block.


def _paged_pool(card, g, L, P, KVH, ps, hd):
    ri = lambda *s: torch.randint(-127, 128, s, generator=g, device=card, dtype=torch.int8)
    rs = lambda *s: torch.rand(s, generator=g, device=card) * 0.02 + 0.005
    return [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rs(L, P, KVH, ps), rs(L, P, KVH, ps)]


def _scattered_table(B, MP, P, seed):
    """A page table of distinct pages 1..P-1 in no order, some slots with
    fewer pages (0 past them)."""
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, P))[:B * MP].reshape(B, MP).astype(np.int32)
    pages[0, 2:] = 0
    return pages


@pytest.mark.parametrize("T,ps,hd", [(512, 512, 128), (40, 16, 16), (100, 64, 12)])
def test_k15_exact(card, T, ps, hd):
    g = _gen(T + ps + hd)
    L, KVH, B, n = 3, 4, 5, 3
    MP = -(-max(T, 2 * ps) // ps)
    P = B * MP + 2
    pool = _paged_pool(card, g, L, P, KVH, ps, hd)
    ref = [a.clone() for a in pool]
    small = _paged_pool(card, g, L, n, KVH, T, hd)
    pt = torch.tensor(_scattered_table(B, MP, P, T), device=card)
    slots = [4, 0, 2]
    before = _kernels.LAUNCHES["K15"]
    tatt.kv_pool_scatter_pages(*small, slots, pt, *pool)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K15"] == before + 1
    tatt.kv_pool_scatter_pages_plain(*small, slots, pt, *ref)
    for a, b in zip(pool, ref):
        assert torch.equal(a[:, 1:], b[:, 1:])


@pytest.mark.parametrize("ps,hd", [(512, 128), (16, 16), (64, 12)])
def test_k14_exact(card, ps, hd):
    g = _gen(ps + hd)
    L, KVH, B, MP = 3, 4, 6, 4
    P = B * MP + 2
    pool = _paged_pool(card, g, L, P, KVH, ps, hd)
    ref = [a.clone() for a in pool]
    rows = [r[:, :, :, 0] for r in _paged_pool(card, g, L, B, KVH, 1, hd)]  # [L, B, KVH(, hd)]
    pt = torch.tensor(_scattered_table(B, MP, P, ps), device=card)
    pt[5] = 0  # a parked slot
    pos = torch.tensor([1, 0, ps, 2 * ps + 3, MP * ps + 7, 5], dtype=torch.int32, device=card)
    tatt.kv_pool_flush_rows(*rows, pos, pt, *pool)
    torch.cuda.synchronize()
    tatt.kv_pool_flush_rows_plain(*rows, pos, pt, *ref)
    for a, b in zip(pool, ref):
        assert torch.equal(a[:, 1:], b[:, 1:])
    neg = [a.clone() for a in pool]
    pt[1, 0], pt[2, 0] = P, -2  # bad page ids and a negative pos: nothing written
    tatt.kv_pool_flush_rows(*rows, torch.tensor([-1, 0, 1, -5, -1, -1], dtype=torch.int32,
                                                device=card), pt, *pool)
    torch.cuda.synchronize()
    for a, b in zip(pool, neg):
        assert torch.equal(a, b)


# K10 and K14 (csrc/kv_flush.cuh: every load issued before any returns, one
# thread a 16-byte unit, or an element where a row is not a multiple of 16
# bytes) over batch 1 / 8 / 32, 2 and 32 layers, head dims 128, 64 and 12;
# pos at -1, 0, S - 1 and S (K14: negative, in range, past the table) in
# turn on every slot; bit-equal to the plain versions (K14 outside the trash
# page, which several slots may write at once).
FLUSH_SHAPES = [(1, 2, 128), (8, 32, 128), (32, 2, 64), (8, 2, 12), (32, 32, 128), (1, 32, 64)]


@pytest.mark.parametrize("B,L,hd", FLUSH_SHAPES)
@pytest.mark.parametrize("cdtype", [torch.int8, torch.float32, torch.bfloat16])
def test_k10_flush_shapes_exact(card, B, L, hd, cdtype):
    g = _gen(B + L + hd)
    KVH, S = 4, 64
    int8 = cdtype == torch.int8
    if int8:
        ri = lambda *s: torch.randint(-127, 128, s, generator=g, device=card, dtype=torch.int8)
        rows = [ri(L, B, KVH, hd), ri(L, B, KVH, hd)]
        cache = [ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd)]
        rows += [torch.rand(L, B, KVH, generator=g, device=card) for _ in range(2)]
        cache += [torch.rand(L, B, KVH, S, generator=g, device=card) for _ in range(2)]
    else:
        rows = [torch.randn(L, B, KVH, hd, generator=g, device=card).to(cdtype)
                for _ in range(2)] + [None, None]
        cache = [torch.randn(L, B, KVH, S, hd, generator=g, device=card).to(cdtype)
                 for _ in range(2)] + [None, None]
    ref = [None if c is None else c.clone() for c in cache]
    base = [-1, 0, S - 1, S] + torch.randint(0, S, (B,), generator=g, device=card).tolist()
    kernel = _kernels.form("K10", cdtype)
    for turn in range(4):
        pos = torch.tensor([base[(b + turn) % len(base)] for b in range(B)], dtype=torch.int32,
                           device=card)
        before = _kernels.LAUNCHES[kernel]
        tatt.kv_cache_flush_rows(rows[0], rows[1], pos, cache[0], cache[1], rows[2], rows[3],
                                 cache[2], cache[3])
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[kernel] == before + 1
        tatt.kv_cache_flush_rows_plain(rows[0], rows[1], pos, ref[0], ref[1], rows[2], rows[3],
                                       ref[2], ref[3])
        for a, b in zip(cache, ref):
            assert a is None or torch.equal(a, b), turn
        rows = [None if r is None else r.roll(1, dims=1) for r in rows]


@pytest.mark.parametrize("B,L,hd", FLUSH_SHAPES)
@pytest.mark.parametrize("ps", [16, 1])
def test_k14_flush_shapes_exact(card, B, L, hd, ps):
    """ps 16 with 4 pages a slot takes the table row beside the rows (a
    lane an entry); ps 1 with 64 pages a slot, past a warp's lanes, reads
    the page entry once pos is in hand."""
    g = _gen(B + L + hd + ps)
    KVH, MP = 4, 64 // ps
    P = B * MP + 3
    pool = _paged_pool(card, g, L, P, KVH, ps, hd)
    ref = [a.clone() for a in pool]
    rows = [r[:, :, :, 0] for r in _paged_pool(card, g, L, B, KVH, 1, hd)]  # [L, B, KVH(, hd)]
    table = _scattered_table(B, MP, P, B + hd)
    if B > 1:
        table[1] = 0  # a parked slot: its rows land on the trash page
    if B > 2:
        table[2, 0], table[2, 1] = P, -2  # page ids outside [0, P): skipped
    pt = torch.tensor(table, device=card)
    base = [-1, 0, 1, MP * ps + 3, 2 * ps + 1, MP * ps - 1] + torch.randint(
        0, MP * ps, (B,), generator=g, device=card).tolist()
    for turn in range(4):
        pos = torch.tensor([base[(b + turn) % len(base)] for b in range(B)], dtype=torch.int32,
                           device=card)
        before = _kernels.LAUNCHES["K14"]
        tatt.kv_pool_flush_rows(*rows, pos, pt, *pool)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["K14"] == before + 1
        tatt.kv_pool_flush_rows_plain(*rows, pos, pt, *ref)
        for a, b in zip(pool, ref):
            assert torch.equal(a[:, 1:], b[:, 1:]), turn
        rows = [r.roll(1, dims=1) for r in rows]


def _paged_decode_case(card, B, KVH, G, hd, ps, MP, pos, qdtype, L=3):
    g = _gen(B * KVH + G + hd + ps)
    P = B * MP + 2
    pool = _paged_pool(card, g, L, P, KVH, ps, hd)
    ptn = _scattered_table(B, MP, P, hd)  # slot 0 holds two pages
    pt = torch.tensor(ptn, device=card)
    fresh = _paged_pool(card, g, 1, B, KVH, 1, hd)
    nk, nv = fresh[0][0, :, :, 0], fresh[1][0, :, :, 0]
    nks, nvs = fresh[2][0, :, :, 0], fresh[3][0, :, :, 0]
    q = torch.randn(B, KVH, G, hd, generator=g, device=card).to(qdtype)
    p = torch.tensor(pos, dtype=torch.int32, device=card)
    live = np.zeros((P, KVH, ps), bool)  # poison every other row of layer 1
    for b, n in enumerate(pos):
        n = min(n, MP * ps)
        for j in range(-(-n // ps)):
            live[ptn[b, j], :, :min(ps, n - j * ps)] = True
    dead = torch.tensor(~live, device=card)
    for a, val in zip(pool, (127, 127, 1e4, 1e4)):
        a[1][dead] = val
    return (q, *pool, pt, p, nk, nv, nks, nvs)


@pytest.mark.parametrize("G,hd,ps", [(1, 128, 512), (4, 128, 256), (2, 12, 16), (1, 64, 64)])
@pytest.mark.parametrize("kernel,name", [("K13", "dma"), ("K20", "fresh")])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_paged_decode_attention_close(card, G, hd, ps, kernel, name, qdtype):
    MP = 4
    pos = [0, ps, ps + 3, MP * ps - 1, 2 * ps - 1]  # slot 0 (two pages) parked at 0
    args = _paged_decode_case(card, 5, 3, G, hd, ps, MP, pos, qdtype)
    before = _kernels.LAUNCHES[kernel]
    got = getattr(tatt, f"paged_flash_decode_attention_{name}")(*args, layer=1)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[kernel] == before + 1
    want = getattr(tatt, f"paged_flash_decode_attention_{name}_plain")(*args, layer=1)
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert err <= DECODE_TOL * peak, (err, peak)


@pytest.mark.parametrize("ps", [512, 64])
def test_k13_equals_k9_on_a_paged_copy(card, ps):
    g = _gen(ps)
    L, B, KVH, G, hd, MP = 2, 4, 3, 2, 128, 4
    S, P = MP * ps, B * MP + 1
    dense = _paged_pool(card, g, L, B, KVH, S, hd)
    pt = torch.tensor(_scattered_table(B, MP, P, ps + 1), device=card)  # slot 0: pos 1
    pool = [torch.zeros((L, P, KVH, ps) + a.shape[4:], dtype=a.dtype, device=card)
            for a in dense]
    for a, d in zip(pool, dense):
        for b in range(B):
            for j in range(MP):
                a[:, pt[b, j]] = d[:, b, :, j * ps:(j + 1) * ps]
    q = torch.randn(B, KVH, G, hd, generator=g, device=card)
    fresh = _paged_pool(card, g, 1, B, KVH, 1, hd)
    nk, nv, nks, nvs = (a[0, :, :, 0] for a in fresh)
    pos = torch.tensor([1, ps, 3 * ps - 5, S], dtype=torch.int32, device=card)
    paged = tatt.paged_flash_decode_attention_dma(q, *pool, pt, pos, nk, nv, nks, nvs, layer=1)
    k9 = tatt.flash_decode_attention_dma(q, dense[0], dense[1], pos, nk, nv, dense[2], dense[3],
                                         nks, nvs, layer=1, block_s=min(256, ps))
    torch.cuda.synchronize()
    assert torch.equal(paged, k9)


# ------------------------------------------------- the split decode cell (K9, K13)
# csrc/decode_split.cuh: spans of the key rows run in parallel, merged by the
# last block of each (slot, kv head).  Each form against its plain version at
# the same splits (DECODE_TOL, 1e-5 for an fp cache); K13 equals K9 on a paged
# copy at every split; a second launch on the stream reuses the counters (left
# zero) and gives the same bits.


@pytest.mark.parametrize("splits", [1, 2, 3, 7, None])
@pytest.mark.parametrize("cdtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd", [(1, 128), (4, 128), (8, 64), (3, 36), (2, 120)])
def test_k9_splits_close(card, G, hd, cdtype, splits):
    S = 2048
    pos = [0, 1500, S - 1]
    if cdtype == torch.int8:
        args, tol = _decode_case(3, 2, G, hd, S, pos, torch.bfloat16), DECODE_TOL
    else:
        args, tol = _fp_decode_case(3, 2, G, hd, S, pos, cdtype, torch.float32), 1e-5
    form = _kernels.form("K9", cdtype)
    before = _kernels.LAUNCHES[form]
    got = tatt.flash_decode_attention_dma(*args, layer=1, splits=splits)
    again = tatt.flash_decode_attention_dma(*args, layer=1, splits=splits)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[form] == before + 2
    assert torch.equal(got, again)
    assert all(int(t.abs().sum()) == 0 for t in tatt._TICKETS.values())
    want = tatt.flash_decode_attention_dma_plain(*args, layer=1, splits=splits)
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


def test_k9_launches_after_a_smaller_residency_query(card):
    """The split cell's occupancy query sets its kernel's shared memory for
    a smaller ring than a later launch needs (key blocks of 128 rows, then
    of 256): the launch still gets what it needs."""
    _kernels.decode_split_residency(torch.int8, 1, 128, 128)
    args = _decode_case(2, 2, 1, 128, 1024, [0, 1000], torch.bfloat16)
    got = tatt.flash_decode_attention_dma(*args, layer=1, block_s=256)
    _kernels.decode_split_residency(torch.int8, 1, 128, 64)
    again = tatt.flash_decode_attention_dma(*args, layer=1, block_s=256)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("splits", [2, 3, None])
@pytest.mark.parametrize("G,hd,ps", [(1, 128, 512), (4, 128, 64), (2, 12, 16)])
def test_k13_splits_close(card, G, hd, ps, splits):
    MP = 2048 // ps if ps > 16 else 40
    pos = [0, ps, ps + 3, MP * ps - 1, 2 * ps - 1]
    args = _paged_decode_case(card, 5, 3, G, hd, ps, MP, pos, torch.bfloat16)
    got = tatt.paged_flash_decode_attention_dma(*args, layer=1, splits=splits)
    torch.cuda.synchronize()
    want = tatt.paged_flash_decode_attention_dma_plain(*args, layer=1, splits=splits)
    err = (got - want).abs().max().item()
    assert err <= DECODE_TOL * want.abs().max().item(), err


@pytest.mark.parametrize("splits", [1, 2, 4, None])
@pytest.mark.parametrize("ps", [512, 64])
def test_k13_equals_k9_on_a_paged_copy_split(card, ps, splits):
    """At every split K13 and K9 (at K13's block) take the same spans in the
    same order: bit for bit on a paged copy."""
    g = _gen(ps + 7)
    L, B, KVH, G, hd = 2, 2, 3, 4, 128
    MP = 2048 // ps
    S, P = MP * ps, B * MP + 1
    dense = _paged_pool(card, g, L, B, KVH, S, hd)
    pt = torch.tensor(np.random.default_rng(ps).permutation(np.arange(1, P))
                      .reshape(B, MP).astype(np.int32), device=card)
    pool = [torch.zeros((L, P, KVH, ps) + a.shape[4:], dtype=a.dtype, device=card)
            for a in dense]
    for a, d in zip(pool, dense):
        for b in range(B):
            for j in range(MP):
                a[:, pt[b, j]] = d[:, b, :, j * ps:(j + 1) * ps]
    q = torch.randn(B, KVH, G, hd, generator=g, device=card)
    fresh = _paged_pool(card, g, 1, B, KVH, 1, hd)
    nk, nv, nks, nvs = (a[0, :, :, 0] for a in fresh)
    pos = torch.tensor([700, S - 1], dtype=torch.int32, device=card)
    paged = tatt.paged_flash_decode_attention_dma(q, *pool, pt, pos, nk, nv, nks, nvs, layer=1,
                                                  splits=splits)
    k9 = tatt.flash_decode_attention_dma(q, dense[0], dense[1], pos, nk, nv, dense[2], dense[3],
                                         nks, nvs, layer=1, block_s=min(256, ps), splits=splits)
    torch.cuda.synchronize()
    assert torch.equal(paged, k9)


# ------------------------------------------------- the page-block split cell (K20, K22)
# csrc/decode_split_page.cuh: runs of whole pages in parallel, a page the
# softmax's rounding block, the partials merged by the last block of each
# (slot, kv head).  Each against its plain version at the same splits (the
# rule's and one; DECODE_TOL) on pools poisoned outside every slot's live
# rows, at pages of one ring tile (32 rows) and of several (512), f32 and
# bf16 queries; a second launch reuses the counters (left zero) and gives
# the same bits.


@pytest.mark.parametrize("splits", [1, None])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd,ps", [(1, 128, 512), (4, 128, 512), (4, 128, 32), (8, 64, 32),
                                     (2, 12, 512)])
@pytest.mark.parametrize("kernel", ["K20", "K22"])
def test_page_split_close(card, kernel, G, hd, ps, qdtype, splits):
    MP = 2048 // ps
    pos = [0, ps, ps + 3, MP * ps - 1, 2 * ps - 1]
    if kernel == "K20":
        args = _paged_decode_case(card, 5, 3, G, hd, ps, MP, pos, qdtype)
        fn = tatt.paged_flash_decode_attention_fresh
    else:  # rows past pos poisoned (the case poisons rows at and past its pos); slot 0 at -1
        args = list(_paged_decode_case(card, 5, 3, G, hd, ps, MP, [p + 1 for p in pos], qdtype))
        p = args[6] - 1
        p[0] = -1
        args = (*args[:6], p)
        fn = tatt.paged_flash_decode_attention
    n = tatt.page_splits(args[0], args[1], args[5], splits)
    assert n == (1 if splits == 1 else min(4, MP) if ps == 512 else 17)
    before = _kernels.LAUNCHES[kernel]
    got = fn(*args, layer=1, splits=splits)
    again = fn(*args, layer=1, splits=splits)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[kernel] == before + 2
    assert torch.equal(got, again)
    assert all(int(t.abs().sum()) == 0 for t in tatt._TICKETS.values())
    plain = tatt.paged_flash_decode_attention_fresh_plain if kernel == "K20" else \
        tatt.paged_flash_decode_attention_plain
    want = plain(*args, layer=1, splits=splits)
    err = (got - want).abs().max().item()
    assert err <= DECODE_TOL * want.abs().max().item(), err
    if kernel == "K22":
        assert not got[0].any()  # pos -1: nothing attended, zeros


@pytest.mark.parametrize("kernel", ["K20", "K22"])
def test_page_cell_shared_memory(card, kernel):
    """The shared memory the wrapper reckons (``page_cell_bytes``) is what
    the kernel asks for; at the 7B pools' pages of 512 rows an SM keeps two
    blocks at every G; a page too large for one block is refused."""
    for G, hd, ps in ((1, 128, 512), (4, 128, 512), (8, 128, 512), (2, 12, 16), (8, 64, 2048)):
        ts = tatt._paged_block(ps)
        blocks, tiles, nbytes = _kernels.page_split_residency(kernel, G, hd, ts, ps)
        assert nbytes == tatt.page_cell_bytes(tiles, ts, ps, hd, G)
        assert tiles >= 2 and (ps != 512 or blocks >= 2), (G, hd, ps, blocks, tiles)
    g = _gen(5)
    pool = _paged_pool(card, g, 1, 2, 1, 8192, 128)
    q = torch.randn(1, 1, 8, 128, device=card)
    pt = torch.ones(1, 1, dtype=torch.int32, device=card)
    pos = torch.tensor([9], dtype=torch.int32, device=card)
    with pytest.raises(NotImplementedError, match="shared memory"):
        if kernel == "K22":
            tatt.paged_flash_decode_attention(q, *pool, pt, pos)
        else:
            fresh = [a[0, :1, :, 0] for a in pool]
            tatt.paged_flash_decode_attention_fresh(q, *pool, pt, pos, *fresh)


@pytest.mark.parametrize("fuse,fused,attn", [(False, False, "flash"),
                                             (False, False, "flash_dma"),
                                             (True, True, "flash_dma")])
def test_paged_engine_card_matches_cpu(card, fuse, fused, attn):
    """The paged engine (page size 32) on the card (K15, K13 or K20, K14;
    the two-launch decode with K11) against the CPU (plain versions), as
    test_engine_card_matches_cpu: tokens equal up to a near-tie; every page
    free again after serving."""
    from tpu_llama_torch import convert
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=512, seq_len=256)
    cpu = tl.random_quant_params(cfg, seed=1, norm_dtype=torch.float32, fuse=fuse,
                                 device="cpu")
    gpu = convert.params_from_numpy(convert.params_to_numpy(cpu), device=card)
    out = []
    for params, dev in ((cpu, "cpu"), (gpu, card)):
        _kernels.reset_counts()
        eng = Engine(params, cfg, max_batch=4, kv_layout="paged", page_size=32, attn=attn,
                     fused=fused, prefill_attn="flash", device=dev)
        b = ContinuousBatcher(eng, prefix_cache_size=2)
        reqs = [Request(prompt_tokens=list(range(3, 3 + n)), steps=n + 12, temperature=0.0,
                        logprobs=2) for n in (5, 130, 40, 130)]
        for r in reqs:
            b.submit(r)
        b.run()
        out.append(reqs)
        if dev == card:
            path = {"K1", "K2", "K6", "K14", "K15", {"flash": "K20"}.get(attn, "K13")} | (
                {"K3", "K4", "K5", "K8", "K11"} if fuse else set())
            assert {k for k, n in _kernels.LAUNCHES.items() if n > 0} == path
            assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
            for e in b._prefix.values():
                eng.release_snapshot(e["snap"])
            assert eng.pool.free_pages == eng.pool.num_pages - 1
    for c, g in zip(*out):
        assert len(c.out_tokens) == 12
        part = next((i for i, (a, b) in enumerate(zip(c.out_tokens, g.out_tokens)) if a != b),
                    None)
        if part is not None:
            (_, top1), (_, top2) = c.out_top_logprobs[part][:2]
            assert top1 - top2 < NEAR_TIE, (attn, part, c.out_tokens, g.out_tokens)


# -------------------------------------------- pool-direct admission (K16, K17, K22)
# K17 is a copy: bit-exact outside the trash page 0 (several slots may write
# it at once).  K16 runs K6's INT8 cell: within K6_TOL of its plain version
# on pools whose rows no query attends are poisoned, and bit-equal to K6 on
# a dense copy of its keys.  K22 rounds q and p to bf16 at its plain version's
# places: DECODE_TOL, as K13.


@pytest.mark.parametrize("ps,hd,Tc", [(512, 128, 256), (16, 16, 8), (64, 12, 32)])
def test_k17_exact(card, ps, hd, Tc):
    g = _gen(ps + hd + Tc)
    L, KVH, B, MP = 3, 4, 6, 4
    P = B * MP + 2
    pool = _paged_pool(card, g, L, P, KVH, ps, hd)
    rows = [r[0] for r in _paged_pool(card, g, 1, B, KVH, Tc, hd)]  # [B, KVH, Tc(, hd)]
    pt = torch.tensor(_scattered_table(B, MP, P, ps), device=card)
    pt[5] = 0  # a parked slot: the trash page
    start = [0, Tc, ps, 2 * ps + Tc, MP * ps, ps - Tc]  # slot 4 past the table: page 0
    ref = [a.clone() for a in pool]
    before = _kernels.LAUNCHES["K17"]
    # the model's form: the start tensor on the card, not read back
    tatt.kv_pool_write_chunk(*rows, pt, torch.tensor(start, device=card, dtype=torch.int32), 1,
                             *pool)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K17"] == before + 1
    tatt.kv_pool_write_chunk_plain(*rows, pt, start, 1, *ref)
    for a, b in zip(pool, ref):
        assert torch.equal(a[:, 1:], b[:, 1:])
    keep = [a.clone() for a in pool]
    pt[1, 0], pt[2, 1] = P, -3  # bad page ids and a negative start: nothing written
    tatt.kv_pool_write_chunk(*rows, pt, [-Tc, 0, ps, -ps, -Tc, -Tc], 2, *pool)
    # a device start whose chunk would cross its page: nothing written
    tatt.kv_pool_write_chunk(*rows, pt, torch.tensor([ps - Tc // 2] + [-Tc] * 5, device=card,
                                                     dtype=torch.int32), 2, *pool)
    torch.cuda.synchronize()
    for a, b in zip(pool, keep):
        assert torch.equal(a, b)


def _k16_case(card, B, G, hd, ps, MP, Tc, start, qdtype, KVH=3, L=3, poison=True):
    g = _gen(B * G + hd + ps + Tc)
    P = B * MP + 2
    pool = _paged_pool(card, g, L, P, KVH, ps, hd)
    ptn = _scattered_table(B, MP, P, hd + 1)
    fresh = [a[0] for a in _paged_pool(card, g, 1, B, KVH, Tc, hd)]
    q = torch.randn(B, Tc, KVH * G, hd, generator=g, device=card).to(qdtype)
    if poison:  # every pool row of layer 1 that no query attends
        live = np.zeros((P, KVH, ps), bool)
        for b, n in enumerate(start):
            for j in range(-(-n // ps)):
                live[ptn[b, j], :, :min(ps, n - j * ps)] = True
        dead = torch.tensor(~live, device=card)
        for a, val in zip(pool, (127, 127, 1e4, 1e4)):
            a[1][dead] = val
    return (q, *pool, torch.tensor(ptn, device=card),
            torch.tensor(start, dtype=torch.int32, device=card), *fresh)


@pytest.mark.parametrize("G,hd,ps,Tc", [(1, 128, 512, 256), (4, 128, 256, 64), (2, 12, 16, 16),
                                        (1, 64, 64, 40), (8, 128, 16, 48)])
@pytest.mark.parametrize("qdtype,odtype", [(torch.float32, torch.float32),
                                           (torch.bfloat16, torch.bfloat16)])
def test_k16_close(card, G, hd, ps, Tc, qdtype, odtype):
    MP = 4
    start = [0, ps, ps + 3, 2 * ps, 3 * ps - Tc - 1]  # slot 0 (two pages) at 0
    args = _k16_case(card, 5, G, hd, ps, MP, Tc, start, qdtype)
    before = _kernels.LAUNCHES["K16"]
    got = tatt.paged_flash_prefill_attention(*args, layer=1, past_pages=3, out_dtype=odtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K16"] == before + 1
    want = tatt.paged_flash_prefill_attention_plain(*args, layer=1, past_pages=3,
                                                    out_dtype=odtype)
    err = (got.float() - want.float()).abs().max().item()
    peak = want.float().abs().max().item()
    assert err <= K6_TOL * peak, (err, peak)


@pytest.mark.parametrize("ps,Tc,start", [(512, 256, [0, 256, 768, 1280]),
                                         (64, 64, [0, 64, 128, 192]), (16, 16, [5, 0, 33, 48])])
def test_k16_equals_k6_on_a_dense_copy(card, ps, Tc, start):
    """K16 over the pool and the fresh rows against K6 over a dense cache
    holding the same past rows at [0, start) and the fresh rows at [start,
    start + Tc): the same cell over the same keys in the same order."""
    B, G, hd, MP, KVH = len(start), 2, 128, 4, 3
    q, kp, vp, ksp, vsp, pt, st, fk, fv, fks, fvs = _k16_case(card, B, G, hd, ps, MP, Tc, start,
                                                              torch.bfloat16, KVH, poison=False)
    S = MP * ps
    dense = [tatt.paged_view(a, pt, 1)[0].clone() for a in (kp, vp, ksp, vsp)]  # [B, KVH, S..]
    for d, f in zip(dense, (fk, fv, fks, fvs)):
        for b, s0 in enumerate(start):
            d[b, :, s0:s0 + Tc] = f[b]
    got = tatt.paged_flash_prefill_attention(q, kp, vp, ksp, vsp, pt, st, fk, fv, fks, fvs,
                                             layer=1, out_dtype=torch.bfloat16)
    k6 = tatt.flash_prefill_attention(q, dense[0], dense[1], st, dense[2], dense[3],
                                      out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert S >= max(start) + Tc and torch.equal(got, k6)


@pytest.mark.parametrize("G,hd,ps", [(1, 128, 512), (4, 128, 256), (2, 12, 16), (1, 64, 64)])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_k22_close(card, G, hd, ps, qdtype):
    MP = 4
    pos = [0, ps, ps + 3, MP * ps - 1, 2 * ps - 1]
    # poison every row past pos (the case poisons rows at and past its pos)
    args = list(_paged_decode_case(card, 5, 3, G, hd, ps, MP, [p + 1 for p in pos], qdtype))[:7]
    args[6] = args[6] - 1
    before = _kernels.LAUNCHES["K22"]
    got = tatt.paged_flash_decode_attention(*args, layer=1)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K22"] == before + 1
    want = tatt.paged_flash_decode_attention_plain(*args, layer=1)
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert err <= DECODE_TOL * peak, (err, peak)


def test_pool_direct_equals_dense_chunked_prefill(card):
    """The pool-direct prefill (K5, K16, K17) against the dense chunked one
    (K5, K18, K6) on fused W8A8 weights with bf16 activations: logits and
    every row of each slot's pages bit-equal."""
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=512, seq_len=512)
    params = tl.random_quant_params(cfg, seed=4, norm_dtype=torch.bfloat16, fuse=True,
                                    device=card)
    B, T, ps, chunk = 3, 512, 128, 64
    toks = torch.randint(3, 512, (B, T), generator=_gen(5), device=card)
    lengths = torch.tensor([512, 300, 77], device=card)
    MP = T // ps
    pool = tl.make_kv_cache(cfg, B, kv_dtype="int8", paged=True, num_pages=B * MP + 1,
                            page_size=ps, device=card)
    table = np.random.default_rng(9).permutation(np.arange(1, B * MP + 1)).reshape(B, MP)
    pool.page_table = torch.tensor(table.astype(np.int32), device=card)
    slots = [2, 0, 1]
    _kernels.reset_counts()
    got, _ = tl.forward_prefill_paged_chunked(params, pool, toks, lengths, slots, cfg,
                                              chunk=chunk)
    assert _kernels.LAUNCHES["K16"] == _kernels.LAUNCHES["K17"] == (T // chunk) * cfg.n_layers
    dense = tl.make_kv_cache(cfg, B, kv_dtype="int8", seq_len=T, device=card)
    want, _ = tl.forward_prefill_chunked(params, dense, toks, lengths, cfg, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for i, slot in enumerate(slots):
        for a in ("k", "v", "ks", "vs"):
            rows = torch.cat([getattr(pool, a)[:, int(pg)] for pg in table[slot]], dim=2)
            assert torch.equal(rows, getattr(dense, a)[:, i]), (slot, a)


def test_pool_direct_engine_card_matches_compact(card, monkeypatch):
    """A paged engine whose admissions pass a lowered pool-direct gate
    (waves of 2 slots, chunks of 32) against the same engine on the compact
    path (K15): greedy tokens equal up to a near-tie (the compact prefill
    attends in one pass, the pool-direct one per chunk: f32 sums in another
    order), every page free again."""
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime import engine as engine_mod

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=512, seq_len=256)
    params = tl.random_quant_params(cfg, seed=2, norm_dtype=torch.float32, fuse=True,
                                    device=card)
    out = []
    for rows in (1 << 30, 64):
        monkeypatch.setattr(engine_mod, "_POOL_DIRECT_ROWS", rows)
        monkeypatch.setattr(engine_mod, "_POOL_CHUNK", 32)
        monkeypatch.setattr(engine_mod, "_WAVE_ROWS", 64)
        _kernels.reset_counts()
        eng = Engine(params, cfg, max_batch=4, kv_layout="paged", page_size=64, device=card)
        b = ContinuousBatcher(eng)
        reqs = [Request(prompt_tokens=list(range(3, 3 + n)), steps=n + 12, temperature=0.0,
                        logprobs=2) for n in (5, 130, 40, 100)]
        for r in reqs:
            b.submit(r)
        b.run()
        out.append(reqs)
        direct = _kernels.LAUNCHES["K16"] > 0
        assert direct == (rows == 64) and (_kernels.LAUNCHES["K15"] == 0) == direct
        assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
        assert eng.pool.free_pages == eng.pool.num_pages - 1
    for c, g in zip(*out):
        assert len(c.out_tokens) == 12
        part = next((i for i, (a, b) in enumerate(zip(c.out_tokens, g.out_tokens)) if a != b),
                    None)
        if part is not None:
            (_, top1), (_, top2) = c.out_top_logprobs[part][:2]
            assert top1 - top2 < NEAR_TIE, (part, c.out_tokens, g.out_tokens)


# ------------------------------------------- the opt-in decodes, K28 and K29


# K12 and K26 at Llama-2 7B widths on a 4-layer stack (layer 1 has trailing
# cells, layer 3 is the last): the shapes of PERF.md's K12 row and batch 32,
# each slot's cache rows at and past its pos poisoned (127, scale 1e4), so a
# cell that read one stale row would miss by orders of magnitude.
K12_7B_POS = {8: [0, 1, 127, 128, 511, 1000, 1900, 2047],
              32: [0, 1, 127, 128, 511, 1000, 1900, 2047] * 4}
K12_7B = [(8, None, 1), (1, [511], 1), (1, [2047], 1), (8, None, 3), (32, None, 1)]


@pytest.fixture(scope="module")
def k12_7b(card):
    from tpu_llama_torch.config import LLAMA2_7B

    cfg = LLAMA2_7B
    L, D, H, KVH, hd = 4, cfg.dim, cfg.hidden_dim, cfg.n_kv_heads, cfg.head_dim
    QO = D + 2 * KVH * hd
    g = _gen(712)

    def qt(n_in, n_out):
        return tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=g, device="cuda",
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=g, device="cuda") * 2e-4 + 1e-4)

    w = (qt(D, D), qt(D, 2 * H), qt(H, D), qt(D, QO))
    rms = [(1 + 0.1 * torch.randn(L, D, generator=g, device="cuda")).to(torch.bfloat16)
           for _ in range(2)]
    return dict(w=w, rms=rms, L=L, D=D, KVH=KVH, hd=hd, S=cfg.seq_len, NH=cfg.n_heads, g=g)


def _k12_7b_case(c, B, pos):
    """Rows, a poisoned cache and rope rows for batch B of ``k12_7b``."""
    g, L, D, KVH, hd, S = c["g"], c["L"], c["D"], c["KVH"], c["hd"], c["S"]
    pos = pos or K12_7B_POS[B]
    kc, vc = (torch.randint(-127, 128, (L, B, KVH, S, hd), generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(L, B, KVH, S, generator=g, device="cuda") * 0.03 + 0.01
              for _ in range(2))
    for b, p in enumerate(pos):
        for a, val in ((kc, 127), (vc, 127), (ks, 1e4), (vs, 1e4)):
            a[:, b, :, p:] = val
    ang = torch.rand(B, hd // 2, generator=g, device="cuda") * 6.3
    x = torch.randn(B, D, generator=g, device="cuda")
    attq = torch.randint(-127, 128, (B, D), generator=g, device="cuda", dtype=torch.int8)
    satt = torch.rand(B, generator=g, device="cuda") * 0.02 + 0.005
    return (x, attq, satt, kc, vc, ks, vs, torch.tensor(pos, dtype=torch.int32, device="cuda"),
            ang.cos(), ang.sin())


@pytest.mark.parametrize("B,pos,layer", K12_7B)
@pytest.mark.parametrize("at", ["rule", "one"])
def test_k12_7b_splits_close(k12_7b, B, pos, layer, at):
    """K12 at 7B widths, its trailing cells at the split rule and at one
    split, against the plain version at the same splits on poisoned caches:
    x_next and the fresh K/V rows bit-equal; the attention output, whose f32
    dots and sums run in the cell's order on the card and in PyTorch's in
    the plain version (at one split too, so it is not bit-equal there: an
    H100 flipped one of 32768 entries at batch 8), within one int8 step on
    at most 1e-3 of entries, its scales within K6_TOL relative and its
    dequantized values within K6_TOL of the largest; one K12 launch per
    call."""
    c = k12_7b
    args = (*_k12_7b_case(c, B, pos), *c["w"], *c["rms"], layer, c["L"], c["NH"])
    n = tfs.fused_splits(B, c["KVH"], 128, c["S"]) if at == "rule" else 1
    before = _kernels.LAUNCHES["K12"]
    got = tfs.fused_step2_layer(*args, splits=n)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K12"] == before + 1
    want = tfs.fused_step2_layer_plain(*args, splits=n)
    assert torch.equal(got[0], want[0])
    if layer + 1 == c["L"]:
        return
    for i in (3, 4, 5, 6):
        assert torch.equal(got[i], want[i])
    d = (got[1].int() - want[1].int()).abs()
    assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(got[2], want[2], rtol=K6_TOL, atol=0)
    att, att_p = (o[1].float() * o[2][:, None] for o in (got, want))
    assert (att - att_p).abs().max().item() <= K6_TOL * att_p.abs().max().item()


@pytest.mark.parametrize("B,pos", [(8, None), (1, [2047])])
@pytest.mark.parametrize("l0", [0, 2])
def test_k26_7b_equals_two_chained_k12(k12_7b, B, pos, l0):
    """At 7B widths and the split rule, one K26 launch per pair of layers
    equals K12 for l0 and then for l0 + 1 on its outputs, bit for bit (the
    last pair (2, 3) stops after its second phase C); one K26 launch."""
    from tpu_llama_torch.ops import fused_step3 as tfs3

    c = k12_7b
    x, attq, satt, *rest = _k12_7b_case(c, B, pos)
    rest = (*rest, *c["w"], *c["rms"])
    L, NH = c["L"], c["NH"]
    one = tfs.fused_step2_layer(x, attq, satt, *rest, l0, L, NH)
    two = tfs.fused_step2_layer(*one[:3], *rest, l0 + 1, L, NH)
    before = _kernels.LAUNCHES["K26"]
    xo, attq_o, satt_o, r1, r2 = tfs3.fused_step3_pair(x, attq, satt, *rest, l0, L, NH)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K26"] == before + 1
    assert torch.equal(xo, two[0])
    assert all(torch.equal(a, b) for a, b in zip(r1, one[3:]))
    if l0 + 2 < L:
        assert torch.equal(attq_o, two[1]) and torch.equal(satt_o, two[2])
        assert all(torch.equal(a, b) for a, b in zip(r2, two[3:]))


@pytest.mark.parametrize("B,KVH,G,hd,H", [(1, 2, 1, 128, 384), (3, 2, 4, 64, 336),
                                          (8, 4, 1, 64, 256), (3, 1, 2, 12, 96)])
def test_k26_equals_two_chained_k12(card, B, KVH, G, hd, H):
    """One K26 launch per pair of layers equals K12 for l0 and then for
    l0 + 1 on its outputs, bit for bit: every output, the rows landed in the
    given buffers, the last pair's second rows untouched."""
    from tpu_llama_torch.ops import fused_step3 as tfs3

    c = _fused_case(B, KVH, G, hd, H, L=4)  # a first pair and the last pair
    L = c["L"]
    rest = (*c["cache"], c["pos"], c["cos"], c["sin"], *c["w"], *c["rms"])
    for l0 in range(0, L, 2):
        one = tfs.fused_step2_layer(c["x"], c["attq"], c["satt"], *rest, l0, L, c["NH"])
        two = tfs.fused_step2_layer(*one[:3], *rest, l0 + 1, L, c["NH"])
        bufs = [torch.full_like(t, 3) for _ in range(2) for t in one[3:]]
        before = _kernels.LAUNCHES["K26"]
        x, attq, satt, r1, r2 = tfs3.fused_step3_pair(c["x"], c["attq"], c["satt"], *rest, l0, L,
                                                      c["NH"], out=(bufs[:4], bufs[4:]))
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["K26"] == before + 1
        assert torch.equal(x, two[0])
        assert all(torch.equal(a, b) for a, b in zip(r1, one[3:]))
        if l0 + 2 == L:
            assert all(bool((t == 3).all()) for t in r2)
        else:
            assert torch.equal(attq, two[1]) and torch.equal(satt, two[2])
            assert all(torch.equal(a, b) for a, b in zip(r2, two[3:]))


def _k27_check(card, c, x, cache, pos, B, D, KVH, G, hd, layer, L, splits, g, tol):
    """One K27 launch at ``splits`` against K9 (same splits), K2 and K11
    launched in turn (bit for bit), against its plain version at the same
    splits (the attention output within one int8 step on at most 1e-3 of
    entries, its dequantized values within ``tol`` of the largest) and its
    linear outputs against K11's plain phases on the kernel's attention."""
    from tpu_llama_torch.ops import fused_step as tfst

    q = torch.randn(B, KVH, G, hd, generator=g, device=card)
    nk, nv = (torch.randint(-127, 128, (B, KVH, hd), generator=g, device=card,
                            dtype=torch.int8) for _ in range(2))
    nks, nvs = (torch.rand(B, KVH, generator=g, device=card) * 0.02 + 0.005 for _ in range(2))
    args = (x, q, nk, nv, nks, nvs, *cache, pos, *c["w"], *c["rms"])
    att = (torch.empty(B, D, dtype=torch.int8, device=card), torch.empty(B, device=card))
    before = _kernels.LAUNCHES["K27"]
    x1, qkv = tfst.fused_step_layer(*args, layer, L, att_out=att, splits=splits)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K27"] == before + 1
    a9 = tatt.flash_decode_attention_dma(q, cache[0], cache[1], pos, nk, nv, cache[2], cache[3],
                                         nks, nvs, layer=layer,
                                         splits=tfst.step_splits(B, KVH, cache[0].shape[3],
                                                                 splits))
    q2, s2 = tq.quantize_activations(a9.reshape(B, D))
    x2, qkv2 = tfl.fused_layer_linear(x, q2, s2, *c["w"], *c["rms"], layer, L)
    assert torch.equal(att[0], q2) and torch.equal(att[1], s2) and torch.equal(x1, x2)
    if layer + 1 < L:
        assert torch.equal(qkv, qkv2)
    att_p = (torch.empty_like(att[0]), torch.empty_like(att[1]))
    tfst.fused_step_layer_plain(*args, layer, L, att_out=att_p, splits=splits)
    d = (att[0].int() - att_p[0].int()).abs()
    assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-3
    deq, deq_p = att[0].float() * att[1][:, None], att_p[0].float() * att_p[1][:, None]
    assert (deq - deq_p).abs().max().item() <= tol * deq_p.abs().max().item()
    views = tfl.layer_views(*c["w"], *c["rms"], layer, L)
    xl, qkvl = tfl.linear_phases_plain(x, att[0], att[1], *views, last=layer + 1 == L)
    assert torch.equal(x1, xl) and (qkvl is None or torch.equal(qkv, qkvl))


@pytest.mark.parametrize("B,KVH,G,hd,H", [(1, 2, 1, 128, 384), (3, 2, 4, 64, 336),
                                          (8, 4, 1, 64, 256), (3, 1, 2, 12, 96)])
@pytest.mark.parametrize("splits", [None, 1, 3])
def test_k27_equals_k9_k2_k11(card, B, KVH, G, hd, H, splits):
    """K27 equals K9 (at the same splits), K2 and K11 launched in turn, bit
    for bit (its cell is K9's split cell, its quant K2's, its phases K11's);
    its quantized attention output is within K12's limits of the plain
    version's, and its linear outputs equal K11's plain phases on that
    output.  At the split rule (1 on these 300-row caches), one split and
    three; every slot's cache rows at and past its pos poisoned (127, scale
    1e4), so a cell that read one stale row would miss by orders of
    magnitude."""
    c = _fused_case(B, KVH, G, hd, H)
    g = _gen(B + hd)
    D, L = KVH * G * hd, c["L"]
    cache = [t.clone() for t in c["cache"]]
    for b, p in enumerate(c["pos"].tolist()):
        for a, val in zip(cache, (127, 127, 1e4, 1e4)):
            a[:, b, :, p:] = val
    for layer in range(L):
        _k27_check(card, c, c["x"], cache, c["pos"], B, D, KVH, G, hd, layer, L, splits, g,
                   DECODE_TOL)


@pytest.mark.parametrize("B,pos,layer", [(8, None, 1), (1, [2047], 1), (32, None, 1),
                                         (8, None, 3)])
@pytest.mark.parametrize("at", ["rule", "one"])
def test_k27_7b_equals_k9_k2_k11(k12_7b, B, pos, layer, at):
    """K27 at 7B widths (batch 8 and 32 with slots at 0..2047, batch 1 at
    pos 2047; layer 1 and the last, 3) on caches poisoned at and past every
    pos, its cells at the split rule (``fused_splits``: 8, 16 and 2 splits)
    and at one split: bit-equal to K9 at the same splits, K2 and K11
    launched in turn; within K12's 7B limits (K6_TOL) of its plain version."""
    c = k12_7b
    x, _, _, kc, vc, ks, vs, pt, _, _ = _k12_7b_case(c, B, pos)
    n = None if at == "rule" else 1
    _k27_check(torch.device("cuda"), c, x, (kc, vc, ks, vs), pt, B, c["D"], c["KVH"], 1,
               c["hd"], layer, c["L"], n, c["g"], K6_TOL)


@pytest.mark.parametrize("hd", [128, 64, 12])
@pytest.mark.parametrize("cdtype", [torch.int8, torch.float32, torch.bfloat16])
def test_k28_exact(card, hd, cdtype):
    """K28 bit-equal to its plain version; a slot at pos S and one below 0
    are skipped."""
    g = _gen(hd + 28)
    L, B, KVH, S = 3, 5, 4, 64
    pos = torch.tensor([0, S, 17, -1, S - 1], dtype=torch.int32, device=card)
    if cdtype == torch.int8:
        cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=g, device=card,
                               dtype=torch.int8) for _ in range(2)]
        cache += [torch.rand(L, B, KVH, S, generator=g, device=card) for _ in range(2)]
    else:
        cache = [torch.randn(L, B, KVH, S, hd, generator=g, device=card).to(cdtype)
                 for _ in range(2)]
    k, v = (torch.randn(B, KVH, hd, generator=g, device=card) * 3 for _ in range(2))
    k[2, 1] = 0.0
    ref = [t.clone() for t in cache]
    before = _kernels.LAUNCHES[_kernels.form("K28", cdtype)]
    tatt.kv_cache_write_decode(k, v, pos, 1, *cache)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[_kernels.form("K28", cdtype)] == before + 1
    tatt.kv_cache_write_decode_plain(k, v, pos, 1, *ref)
    assert all(torch.equal(a, b) for a, b in zip(cache, ref))


@pytest.mark.parametrize("m,k,n", [(300, 4096, 384), (512, 11008, 256), (4096, 256, 136),
                                   (260, 48, 40), (4096, 11008, 4096), (1000, 4096, 1000),
                                   (4100, 6160, 520), (300, 5952, 136)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8])
def test_k29_equals_k1(card, monkeypatch, m, k, n, dtype, with_res, cluster):
    """K29, taken with the switch above 256 rows (at the cluster size
    ``rows_resident_cluster`` picks) or called at each cluster size the
    kernel takes, equals K1 bit for bit: K 11008 (16 rows, two consumers),
    6160 (16 rows, four), 5952 (32 rows, two), the rest 32 rows and four; M
    1000 and 4100 not multiples of any cluster's rows."""
    g = _gen(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=card) * 0.1
    w = tq.ChannelQuantTensor(
        q=torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8),
        s=torch.rand(n, generator=g, device=card) * 1e-3)
    res = (torch.randn(m, n, generator=g, device=card) * 4).to(dtype) if with_res else None
    monkeypatch.setenv("TPU_LLAMA_ROWS_RESIDENT", "1")
    before = _kernels.LAUNCHES["K29"]
    if cluster is None:
        got = tm.w8a8_matmul_prequant(xq, sx, w, out_dtype=dtype, residual=res)
    else:
        got = tm.w8a8_rows_resident(xq, sx, w, out_dtype=dtype, residual=res, cluster=cluster)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K29"] == before + 1
    monkeypatch.delenv("TPU_LLAMA_ROWS_RESIDENT")
    want = tm.w8a8_matmul_prequant(xq, sx, w, out_dtype=dtype, residual=res)
    assert torch.equal(got, want)
    assert torch.equal(got, tm.w8a8_matmul_prequant_plain(xq, sx, w, out_dtype=dtype,
                                                          residual=res))


@pytest.mark.parametrize("fused", ["mega3", "mega"])
def test_engine_mega_card_matches_cpu(card, fused):
    """The opt-in decodes on a tiny f32-activation engine, card against CPU
    with the same explicit mode: greedy tokens equal up to a near tie (the
    card's K9 cell sums in another order), every kernel of the path
    launched and no other."""
    from tpu_llama_torch import convert
    from tpu_llama_torch.config import ModelConfig
    from tpu_llama_torch.models import llama as tl
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request

    cfg = ModelConfig(dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                      vocab_size=512, seq_len=256)
    cpu = tl.random_quant_params(cfg, seed=1, norm_dtype=torch.float32, fuse=True, device="cpu")
    gpu = convert.params_from_numpy(convert.params_to_numpy(cpu), device=card)
    out = []
    for params, dev in ((cpu, "cpu"), (gpu, card)):
        _kernels.reset_counts()
        b = ContinuousBatcher(Engine(params, cfg, kv_dtype="int8", max_batch=4, fused=fused,
                                     prefill_attn="flash", device=dev))
        reqs = [Request(prompt_tokens=list(range(3, 3 + n)), steps=n + 12, temperature=0.0,
                        logprobs=2) for n in (5, 130, 40)]
        for r in reqs:
            b.submit(r)
        b.run()
        out.append(reqs)
        if dev == card:
            path = {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K10"} | (
                {"K9", "K26"} if fused == "mega3" else {"K27"})
            assert {k for k, n in _kernels.LAUNCHES.items() if n > 0} == path
            assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
    for c, g in zip(*out):
        assert len(c.out_tokens) == 12
        part = next((i for i, (a, b) in enumerate(zip(c.out_tokens, g.out_tokens)) if a != b),
                    None)
        if part is not None:
            (_, top1), (_, top2) = c.out_top_logprobs[part][:2]
            assert top1 - top2 < NEAR_TIE, (fused, part, c.out_tokens, g.out_tokens)


# -------------------------------------- the TP decode's kernels (K21, K23, K24)
# K21 rounds q and p to bf16 at its plain version's places (INT8 caches):
# DECODE_TOL, as K9 and K19; on f32 and bf16 caches nothing is rounded and
# only the f32 sums' order and expf differ: 1e-5 of the largest output with
# f32 queries.  K23 and K24 are K11's arithmetic: exact.


@pytest.mark.parametrize("block_s", [None, 64])
@pytest.mark.parametrize("cdtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd", [(1, 128), (4, 64)])
def test_k21_close(card, G, hd, cdtype, block_s):
    g = _gen(21 * hd + G)
    L, B, KVH, S = 2, 5, 3, 256
    pos = [0, 37, 128, 255, 200]
    shape = (L, B, KVH, S, hd)
    int8 = cdtype == torch.int8
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g, device=card, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=g, device=card) * 0.03 + 0.01
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=g, device=card).to(cdtype) for _ in range(2))
        ks = vs = None
    for b, p in enumerate(pos):  # rows past pos poisoned: K21 attends s <= pos
        for a, val in ((k, 127 if int8 else 1e4), (v, 127 if int8 else 1e4), (ks, 1e4),
                       (vs, 1e4)):
            if a is not None:
                a[:, b, :, p + 1:] = val
    q = torch.randn(B, KVH, G, hd, generator=g, device=card).to(
        torch.bfloat16 if int8 else torch.float32)
    pt = torch.tensor(pos, dtype=torch.int32, device=card)
    kernel = _kernels.form("K21", cdtype)
    before = _kernels.LAUNCHES[kernel]
    got = tatt.flash_decode_attention(q, k, v, pt, ks, vs, block_s=block_s, layer=1)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[kernel] == before + 1
    want = tatt.flash_decode_attention_plain(q, k, v, pt, ks, vs, block_s=block_s, layer=1)
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    assert err <= (DECODE_TOL if int8 else 1e-5) * peak, (err, peak)


@pytest.mark.parametrize("B", [5, 37])
def test_k23_k24_exact(card, B):
    """K23 and K24 bit-equal to their plain versions at 5 rows (one block of
    16) and 37 (blocks of 32, the last partial), layers 0 and L - 1."""
    g = _gen(23 + B)
    L, D, H, QO = 3, 256, 384, 512

    def w(n_in, n_out):
        return tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=g, device=card,
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=g, device=card) * 2e-3 + 1e-4)

    w13, w2, wqkv = w(D, 2 * H), w(H, D), w(D, QO)
    rms = (1 + 0.1 * torch.randn(L, D, generator=g, device=card)).to(torch.bfloat16)
    x = torch.randn(B, D, generator=g, device=card)
    for layer in (0, L - 1):
        before = (_kernels.LAUNCHES["K23"], _kernels.LAUNCHES["K24"])
        got = (tfl.fused_ffn_stacked(x, w13, w2, rms, layer),
               tfl.fused_rms_qkv_stacked(x, wqkv, rms, layer))
        torch.cuda.synchronize()
        assert (_kernels.LAUNCHES["K23"], _kernels.LAUNCHES["K24"]) == (before[0] + 1,
                                                                         before[1] + 1)
        assert torch.equal(got[0], tfl.fused_ffn_stacked_plain(x, w13, w2, rms, layer))
        assert torch.equal(got[1], tfl.fused_rms_qkv_stacked_plain(x, wqkv, rms, layer))


# K23 and K24 at Llama-2 7B's local widths under tensor parallelism (D 4096,
# Hl = 11008 / tp, QOl = 12288 / tp): a two-layer stack per tp, shared by
# the cases of that tp.
@pytest.fixture(scope="module", params=[1, 2, 4, 8], ids=lambda tp: f"tp{tp}")
def tp_span_7b(card, request):
    tp = request.param
    g = _gen(2300 + tp)
    L, D, H, QO = 2, 4096, 11008 // tp, 12288 // tp

    def w(n_in, n_out):
        return tq.ChannelQuantTensor(
            q=torch.randint(-127, 128, (L, n_out, n_in), generator=g, device=card,
                            dtype=torch.int8),
            s=torch.rand(L, n_out, generator=g, device=card) * 2e-4 + 1e-4)

    rms = 1 + 0.1 * torch.randn(L, D, generator=g, device=card)
    return dict(tp=tp, L=L, D=D, w13=w(D, 2 * H), w2=w(H, D), wqkv=w(D, QO), rms=rms, g=g)


@pytest.mark.parametrize("rdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 8, 32, 37])
def test_k23_k24_7b_exact(tp_span_7b, B, rdtype):
    """K23 and K24 on the streaming body at 7B local widths, tp 1 / 2 / 4 /
    8, with f32 and bf16 rms weights, on layers 0 and L - 1: bit-equal to
    their plain versions, one launch each per call (37 rows: two row groups
    in the one launch), and a second call on the stream's workspace, which
    the first must leave zero, gives the same bits."""
    c = tp_span_7b
    x = torch.randn(B, c["D"], generator=c["g"], device="cuda") * 2
    rms = c["rms"].to(rdtype)
    for layer in (0, c["L"] - 1):
        for kid, fn, plain, args in (
                ("K23", tfl.fused_ffn_stacked, tfl.fused_ffn_stacked_plain,
                 (x, c["w13"], c["w2"], rms, layer)),
                ("K24", tfl.fused_rms_qkv_stacked, tfl.fused_rms_qkv_stacked_plain,
                 (x, c["wqkv"], rms, layer))):
            before = _kernels.LAUNCHES[kid]
            got = fn(*args)
            torch.cuda.synchronize()
            assert _kernels.LAUNCHES[kid] == before + 1
            want = plain(*args)
            assert torch.equal(got, want), (kid, B, layer, (got - want).abs().max().item())
            assert torch.equal(fn(*args), got), (kid, "second launch")


@pytest.mark.parametrize("tp", [1, 2])
def test_k11_k23_k24_k12_in_turn_on_one_stream(k12_7b, tp):
    """K11, then K23 and K24 at tp's local widths (tp 1: K11's own D and H),
    then K12, launched in turn on one stream, twice over: each bit-equal to
    its plain version (K12: x_next and the fresh K/V rows; its attention
    output within one int8 step on at most 1e-3 of entries, as
    test_k12_7b_splits_close), so none of them finds another's workspace
    words or scratch where it keeps its own."""
    c = k12_7b
    L, D = c["L"], c["D"]
    g = _gen(2400 + tp)
    if tp == 1:
        w13, w2, wqkv = c["w"][1], c["w"][2], c["w"][3]
    else:
        H, QO = c["w"][2].in_features // tp, c["w"][3].out_features // tp

        def w(n_in, n_out):
            return tq.ChannelQuantTensor(
                q=torch.randint(-127, 128, (L, n_out, n_in), generator=g, device="cuda",
                                dtype=torch.int8),
                s=torch.rand(L, n_out, generator=g, device="cuda") * 2e-4 + 1e-4)

        w13, w2, wqkv = w(D, 2 * H), w(H, D), w(D, QO)
    args12 = (*_k12_7b_case(c, 8, None), *c["w"], *c["rms"], 1, L, c["NH"])
    x, attq, satt = args12[:3]
    rf, ra = c["rms"]
    for _ in range(2):
        x11, qkv11 = tfl.fused_layer_linear(x, attq, satt, *c["w"], rf, ra, 1, L)
        f23 = tfl.fused_ffn_stacked(x, w13, w2, rf, 1)
        f24 = tfl.fused_rms_qkv_stacked(x, wqkv, ra, 2)
        got = tfs.fused_step2_layer(*args12)
        torch.cuda.synchronize()
        want11 = tfl.fused_layer_linear_plain(x, attq, satt, *c["w"], rf, ra, 1, L)
        assert torch.equal(x11, want11[0]) and torch.equal(qkv11, want11[1])
        assert torch.equal(f23, tfl.fused_ffn_stacked_plain(x, w13, w2, rf, 1))
        assert torch.equal(f24, tfl.fused_rms_qkv_stacked_plain(x, wqkv, ra, 2))
        want = tfs.fused_step2_layer_plain(*args12)
        assert torch.equal(got[0], want[0])
        for i in (3, 4, 5, 6):
            assert torch.equal(got[i], want[i])
        d = (got[1].int() - want[1].int()).abs()
        assert d.max().item() <= 1 and (d != 0).float().mean().item() <= 1e-3


# ------------------------------ the normalized cluster cell (K19, K21 single-pass)
# csrc/decode_split_norm.cuh: spans of the key rows run as the blocks of one
# thread-block cluster, which agree on the softmax's max and denominator
# before any p is rounded.  Each form against its plain version at the same
# splits (DECODE_TOL, 1e-5 for an fp cache), on caches poisoned at and past
# every row the slot does not attend; a second launch gives the same bits.


def _norm_case(cdtype, G, hd, S, pos, fresh):
    """K19's arguments (``fresh``: rows s < pos attend) or K21's (q, k, v,
    pos, ks, vs: rows s <= pos), every other row poisoned (INT8: 127 with
    scale 1e4; fp: 1e4)."""
    B, KVH = len(pos), 2
    if cdtype == torch.int8:
        args = list(_decode_case(B, KVH, G, hd, S, pos, torch.bfloat16))
        k, v, ks, vs = args[1], args[2], args[6], args[7]
    else:
        args = list(_fp_decode_case(B, KVH, G, hd, S, [S] * B, cdtype, torch.float32))
        args[3] = torch.tensor(pos, dtype=torch.int32, device="cuda")
        k, v, ks, vs = args[1], args[2], None, None
    for b, p in enumerate(pos):
        first = max(p if fresh else p + 1, 0)
        for a, val in ((k, 127 if ks is not None else 1e4), (v, 127 if ks is not None else 1e4),
                       (ks, 1e4), (vs, 1e4)):
            if a is not None:
                a[:, b, :, first:] = val
    if fresh:
        return args
    return [args[0], k, v, args[3], ks, vs]


@pytest.mark.parametrize("splits", [1, 2, 4, 8, None])
@pytest.mark.parametrize("cdtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd", [(1, 128), (4, 128), (8, 64), (3, 36)])
def test_k19_splits_close(card, G, hd, cdtype, splits):
    S = 2048
    args = _norm_case(cdtype, G, hd, S, [0, 1, 700, S - 1], fresh=True)
    form = _kernels.form("K19", cdtype)
    before = _kernels.LAUNCHES[form]
    got = tatt.flash_decode_attention_fresh(*args, layer=1, splits=splits)
    again = tatt.flash_decode_attention_fresh(*args, layer=1, splits=splits)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[form] == before + 2
    assert torch.equal(got, again)
    want = tatt.flash_decode_attention_fresh_plain(*args, layer=1, splits=splits)
    err = (got - want).abs().max().item()
    tol = DECODE_TOL if cdtype == torch.int8 else 1e-5
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("splits", [1, 2, 4, 8, None])
@pytest.mark.parametrize("cdtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd", [(1, 128), (4, 64), (2, 36)])
def test_k21_splits_close(card, G, hd, cdtype, splits):
    """The single-pass form at a negative pos (zeros), 0, mid-cache and the
    last row."""
    S = 1024
    args = _norm_case(cdtype, G, hd, S, [-1, 0, 600, S - 1], fresh=False)
    form = _kernels.form("K21", cdtype)
    before = _kernels.LAUNCHES[form]
    got = tatt.flash_decode_attention(*args, layer=1, splits=splits)
    again = tatt.flash_decode_attention(*args, layer=1, splits=splits)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[form] == before + 2
    assert torch.equal(got, again)
    assert int(torch.count_nonzero(got[0])) == 0
    want = tatt.flash_decode_attention_plain(*args, layer=1, splits=splits)
    err = (got - want).abs().max().item()
    tol = DECODE_TOL if cdtype == torch.int8 else 1e-5
    assert err <= tol * want.abs().max().item(), err


def test_norm_cell_refuses_spans_too_long(card):
    """Every score of a split's span stays in shared memory: eight query rows
    over 8192 rows in one split do not fit and are refused; eight splits of
    1024 rows fit and hold to the plain version."""
    S = 8192
    args = _norm_case(torch.int8, 8, 128, S, [S - 1, 4000], fresh=True)
    with pytest.raises(RuntimeError, match="K19"):
        tatt.flash_decode_attention_fresh(*args, layer=1, splits=1)
    got = tatt.flash_decode_attention_fresh(*args, layer=1, splits=8)
    torch.cuda.synchronize()
    want = tatt.flash_decode_attention_fresh_plain(*args, layer=1, splits=8)
    assert (got - want).abs().max().item() <= DECODE_TOL * want.abs().max().item()


@pytest.mark.parametrize("kernel", ["K19", "K21"])
def test_norm_cell_residency(card, kernel):
    """At the 7B table's shapes the cell keeps two blocks an SM, three for
    clusters of more than two blocks, so that every cluster the split rule
    launches there (B * KVH of them, 256 blocks in all) is resident at once."""
    for B, KVH, G, splits in ((8, 32, 1, 1), (8, 8, 4, 4), (1, 32, 1, 8), (8, 4, 1, 8)):
        assert tatt.norm_splits(B, KVH, 128, 2048) == splits
        blocks, tiles, nbytes, clusters = _kernels.norm_split_residency(
            kernel, torch.int8, G, 128, 2048, 128, splits)
        assert blocks >= (3 if splits > 2 else 2) and 2 <= tiles <= 6, (blocks, tiles, nbytes)
        assert clusters >= B * KVH, (clusters, B * KVH)


# -------------------------------------------- the text server and all-position logits
# A 2-layer model at Llama-2 7B's widths in the served layouts (fused W8A8,
# dense INT8 cache).  The server's greedy answer must be the direct
# batcher's token for token on the same engine (one request: the same
# admission and the same steps).  prefill_with_all_logits on the card must
# lie within the smoke's LOGITS_TOL (5e-2 of max |logit|, chip_smoke.py) of
# its CPU plain path at every position, both sides on K6's function
# (prefill "flash"): a moved int8 of K3-K5 moves logits by up to ~3%.
LOGITS_TOL = 5e-2


def _7b_2layer(card, seed, norm_dtype):
    import dataclasses

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models import llama as tl

    cfg = dataclasses.replace(LLAMA2_7B, n_layers=2)
    return cfg, tl.random_quant_params(cfg, seed=seed, norm_dtype=norm_dtype, fuse=True,
                                       device=card)


def test_server_greedy_equals_direct_batcher_7b_width(card):
    import json
    import urllib.request

    from tpu_llama_torch.io.tokenizer import make_byte_tokenizer
    from tpu_llama_torch.runtime import ContinuousBatcher, Engine, Request
    from tpu_llama_torch.runtime.server import LlamaServer

    cfg, params = _7b_2layer(card, 3, torch.bfloat16)
    tok = make_byte_tokenizer([(f"<pad{i}>", -1e5) for i in range(cfg.vocab_size - 259)])
    engine = Engine(params, cfg, max_batch=4, kv_dtype="int8", seq_len=256)
    assert engine.decode_fused == "mega2"
    srv = LlamaServer(engine, tok, port=0, warmup=True, warmup_max_bucket=64).start()
    try:
        assert srv.warmup_buckets == [16, 32, 64]
        prompt = "Once upon a time, there was a little card that served text."
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps(dict(prompt=prompt, steps=96, temperature=0.0)).encode(),
            headers={"Content-Type": "application/json"})
        _kernels.reset_counts()
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())
        launched = {k for k, n in _kernels.LAUNCHES.items() if n > 0}
        assert {"K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10", "K12"} == launched
        assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
    finally:
        srv.stop()
    engine.reset()
    direct = Request(prompt_tokens=tok.encode(prompt), steps=96, temperature=0.0)
    b = ContinuousBatcher(engine)
    b.submit(direct)
    b.run()
    assert got["tokens"] == direct.out_tokens and len(got["tokens"]) > 0
    assert got["text"] == tok.decode(direct.out_tokens, prev_token=direct.prompt_tokens[-1])


def test_prefill_with_all_logits_card_matches_cpu(card):
    from tpu_llama_torch import convert
    from tpu_llama_torch.runtime import Engine

    cfg, gpu = _7b_2layer(card, 4, torch.float32)
    cpu = convert.params_from_numpy(convert.params_to_numpy(gpu), device="cpu")
    prompt = [1] + [int(t) for t in np.random.default_rng(4).integers(3, cfg.vocab_size, 99)]
    out = {}
    for params, dev in ((gpu, card), (cpu, "cpu")):
        eng = Engine(params, cfg, max_batch=2, kv_dtype="int8", seq_len=256,
                     prefill_attn="flash", device=dev)
        _kernels.reset_counts()
        out[dev] = eng.prefill_with_all_logits(prompt, 1)
        if dev == card:  # the fused prefill body, and K2 + K1 for the classifier at M = T
            assert {k for k, n in _kernels.LAUNCHES.items() if n > 0} == {
                "K1", "K2", "K3", "K4", "K5", "K6", "K7"}
            assert all(v == 0 for v in _kernels.PLAIN_CALLS.values())
    g, c = out[card], out["cpu"]
    assert g.shape == c.shape == (100, cfg.vocab_size) and np.isfinite(g).all()
    assert np.abs(g - c).max() <= LOGITS_TOL * np.abs(c).max()

"""Port parity of the fused prefill passes: K3 ``rmsnorm_quantize``, K4
``silu_mul_quantize``, K5 ``rope_split_quantize`` and K1's residual
epilogue, each plain version against the JAX package's Pallas kernel run
in interpret mode (as the JAX tests run it on the CPU), on inputs made
with numpy from a seed.

Where the bytes are not equal, the reason is XLA's CPU code, not the
formula: inside the interpreted Pallas body XLA contracts ``a * b + c``
into one fused multiply-add and computes ``rsqrt`` and the logistic with
its own approximations, while the port (and the TPU kernels, and the
port's CUDA kernels) round each product and sum.  Limits, of max |value|
or of the value:

* K3: int8 within one step on at most 0.1% of entries; scales within
  2^-20 (8 f32 ulps).  XLA's rsqrt is not correctly rounded and its
  f32 sum of squares runs in another order than the port's f64 sum, so a
  scale moves by an ulp or two and a rare int8 by one step.
* K4: the same limits: XLA's logistic and PyTorch's sigmoid part by an
  ulp on a few inputs, which moves a row's scale when it holds the row's
  absmax.
* K5: int8 within one step on at most 0.1% of entries, scales within
  2^-20; f32 q within 2^-22 of max |qkv| (the rotation's FMA), bf16 q
  within one bf16 step (2^-8) of the value.
* K1 with a residual: bf16 bit-equal; f32 within 2^-23 (|r| + |r + mm|)
  elementwise, since XLA fuses the epilogue's rescale and the residual add
  into one FMA where the port rounds the matmul term first, as the TPU
  kernel and the unfused ``x + mm`` do.

The port's own arithmetic is checked exactly: K3 against a numpy rendering
of its formula, K5 against ``apply_rope`` + ``quantize_kv`` in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import matmul as jm
from tpu_llama.ops import quant as jq
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import matmul as tm
from tpu_llama_torch.ops import quant as tq

torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
FLIP_SHARE = 1e-3  # of int8 entries that may move by one step
SCALE_RTOL = 2.0 ** -20


def _pair(x, dt):
    """numpy f32 -> (JAX array in dt[0], torch tensor holding the same values in dt[1])."""
    xj = jnp.asarray(x, dt[0])
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dt[1])


def _rows(rng, m, n):
    x = (rng.standard_normal((m, n)) * rng.uniform(0.05, 20, (m, 1))).astype(np.float32)
    x[1] = 0.0  # an all-zero row: scale 0, q 0
    return x


def _int8_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1, d.max()
    assert (d != 0).mean() <= FLIP_SHARE, (d != 0).mean()


def _scales_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=SCALE_RTOL, atol=0)


# --------------------------------------------------------------------- K3


def _rmsnorm_quant_numpy(x, w):
    """The port's K3 formula in numpy: f64 sum of squares rounded to f32,
    times f32(1/IN), then correctly rounded f32 steps."""
    x32 = x.astype(np.float32)
    ss = (x32.astype(np.float64) ** 2).sum(-1, keepdims=True).astype(np.float32)
    ms = ss * (np.float32(1) / np.float32(x.shape[-1]))
    r = np.float32(1) / np.sqrt(np.float32(1e-5) + ms)
    xf = (x32 * r) * w.astype(np.float32)
    s = np.abs(xf).max(-1) * (np.float32(1) / np.float32(127))
    inv = np.where(s > 0, np.float32(1) / np.where(s > 0, s, np.float32(1)), np.float32(0))
    q = np.clip(np.rint(xf * inv[:, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


@pytest.mark.parametrize("m,n", [(8, 256), (40, 256), (8, 384), (40, 384), (8, 4096)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_k3_plain_matches_pallas(m, n, dt):
    rng = np.random.default_rng(m * n)
    xj, xt = _pair(_rows(rng, m, n), dt)
    wj, wt = _pair((1 + 0.3 * rng.standard_normal(n)).astype(np.float32), dt)
    qj, sj = jq.rmsnorm_quantize_pallas(xj, wj)
    q, s = tq.rmsnorm_quantize(xt, wt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.shape == (m, n)
    _int8_close(q.numpy(), qj)
    _scales_close(s.numpy(), sj)
    assert s[1] == 0 and not q[1].any()
    qn, sn = _rmsnorm_quant_numpy(xt.float().numpy(), wt.float().numpy())
    np.testing.assert_array_equal(q.numpy(), qn)
    np.testing.assert_array_equal(s.numpy(), sn)


def test_k3_plain_rms_factor_is_correctly_rounded():
    """K3's plain factor r = 1 / sqrt(1e-5 + ms) equals numpy's correctly
    rounded f32 steps on every row (the CUDA kernel's ``__fsqrt_rn``):
    PyTorch's vectorised f32 sqrt is 1 ulp off on some rows on AVX-512
    hosts, which broke the exact comparison of test_k3_plain_matches_pallas."""
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((400, 384)) * rng.uniform(0.01, 30, (400, 1))).astype(np.float32)
    ss = (x.astype(np.float64) ** 2).sum(-1, keepdims=True).astype(np.float32)
    want = np.float32(1) / np.sqrt(np.float32(1e-5) + ss * (np.float32(1) / np.float32(384)))
    np.testing.assert_array_equal(tq.rms_factor(torch.tensor(x)).numpy(), want)


def test_k3_takes_weights_of_another_dtype():
    rng = np.random.default_rng(3)
    x = _rows(rng, 16, 128)
    w = (1 + 0.3 * rng.standard_normal(128)).astype(np.float32)
    wt = torch.tensor(w).to(torch.bfloat16)
    q, s = tq.rmsnorm_quantize(torch.tensor(x), wt)
    q2, s2 = tq.rmsnorm_quantize(torch.tensor(x), wt.float())
    assert torch.equal(q, q2) and torch.equal(s, s2)


# --------------------------------------------------------------------- K4


@pytest.mark.parametrize("m,h", [(8, 256), (40, 256), (8, 200), (40, 200)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_k4_plain_matches_pallas_on_w13_halves(m, h, dt):
    """The port reads gate and up as the column halves of one [M, 2H]
    tensor, as the fused prefill's w13 product leaves them."""
    rng = np.random.default_rng(m + h)
    gu = (rng.standard_normal((m, 2 * h)) * rng.uniform(0.1, 8, (m, 1))).astype(np.float32)
    gu[1] = 0.0
    guj, gut = _pair(gu, dt)
    qj, sj = jq.silu_mul_quantize_pallas(guj[:, :h], guj[:, h:])
    gate, up = gut[:, :h], gut[:, h:]
    assert not gate.is_contiguous()
    q, s = tq.silu_mul_quantize(gate, up)
    _int8_close(q.numpy(), qj)
    _scales_close(s.numpy(), sj)
    assert s[1] == 0 and not q[1].any()
    qc, sc = tq.silu_mul_quantize(gate.contiguous(), up.contiguous())
    assert torch.equal(q, qc) and torch.equal(s, sc)


# --------------------------------------------------------------------- K5


def _rope_rows(rng, m, hd, S=64):
    """cos/sin [m, hd/2] gathered at positions that are not 0..m-1."""
    pos = rng.integers(0, S, m)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd // 2, dtype=np.float64) * 2 / hd))
    ang = np.arange(S, dtype=np.float64)[:, None] * inv_freq[None, :]
    return np.cos(ang).astype(np.float32)[pos], np.sin(ang).astype(np.float32)[pos]


def _k5_case(seed, m, kvh, nh=2, hd=128, dt=DTYPES[0]):
    rng = np.random.default_rng(seed)
    D = nh * hd
    qkv = (rng.standard_normal((m, D + 2 * kvh * hd)) * 3).astype(np.float32)
    qkv[3, D:] = 0.0  # a row whose K and V heads are all zero
    cos, sin = _rope_rows(rng, m, hd)
    qkvj, qkvt = _pair(qkv, dt)
    return D, qkvj, qkvt, cos, sin


@pytest.mark.parametrize("kvh", [1, 2])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_k5_plain_matches_pallas(kvh, dt):
    m, hd = 40, 128
    D, qkvj, qkvt, cos, sin = _k5_case(kvh, m, kvh, dt=dt)
    want = [np.asarray(a) for a in
            jq.rope_split_quantize_pallas(qkvj, jnp.asarray(cos), jnp.asarray(sin), D, kvh, hd)]
    got = tq.rope_split_quantize(qkvt, torch.tensor(cos), torch.tensor(sin), D, kvh, hd)
    q, kq, ks, vq, vs = (t.float().numpy() if t.is_floating_point() else t.numpy() for t in got)
    assert got[0].dtype == dt[1] and got[0].shape == (m, D)
    assert kq.shape == (m, kvh * hd) and ks.shape == (m, kvh)
    wq = want[0].astype(np.float32)
    if dt[1] == torch.float32:
        assert np.abs(q - wq).max() <= 2.0 ** -22 * np.abs(qkvt.float().numpy()).max()
    else:
        assert (np.abs(q - wq) <= 2.0 ** -8 * np.abs(wq)).all()
    _int8_close(kq, want[1])
    _scales_close(ks, want[2])
    np.testing.assert_array_equal(vq, want[3])  # no rotation: no FMA, exact
    np.testing.assert_array_equal(vs, want[4])
    assert ks[3].max() == 0 and vs[3].max() == 0


def test_k5_plain_is_apply_rope_and_quantize_kv_in_f32():
    """In f32 K5 is the unfused chain's arithmetic: apply_rope on q and k,
    quantize_kv on k and v, bit for bit."""
    from tpu_llama_torch.models.llama import apply_rope

    m, kvh, nh, hd = 24, 2, 4, 64
    D, _, x, cos, sin = _k5_case(7, m, kvh, nh=nh, hd=hd)
    c, s = torch.tensor(cos), torch.tensor(sin)
    q, kq, ks, vq, vs = tq.rope_split_quantize(x, c, s, D, kvh, hd)
    KVD = kvh * hd
    assert torch.equal(q, apply_rope(x[:, :D].reshape(m, nh, hd), c, s).reshape(m, D))
    kq2, ks2 = tatt.quantize_kv(apply_rope(x[:, D:D + KVD].reshape(m, kvh, hd), c, s))
    vq2, vs2 = tatt.quantize_kv(x[:, D + KVD:].reshape(m, kvh, hd))
    assert torch.equal(kq, kq2.reshape(m, KVD)) and torch.equal(ks, ks2)
    assert torch.equal(vq, vq2.reshape(m, KVD)) and torch.equal(vs, vs2)


def test_k5_writes_a_head_major_cache_block_in_place():
    """``out=`` views of a [B, KVH, S, hd] cache hold the JAX layout's
    results after the transpose; rows past T are untouched."""
    B, T, S, kvh, hd = 2, 8, 12, 2, 16
    D, _, x, cos, sin = _k5_case(9, B * T, kvh, nh=4, hd=hd)
    c, s = torch.tensor(cos), torch.tensor(sin)
    ref = tq.rope_split_quantize(x, c, s, D, kvh, hd)
    ck = torch.full((B, kvh, S, hd), 5, dtype=torch.int8)
    cv = ck.clone()
    cks = torch.full((B, kvh, S), 7.0)
    cvs = cks.clone()
    out = [a[:, :, :T].transpose(1, 2) for a in (ck, cks, cv, cvs)]
    got = tq.rope_split_quantize(x, c, s, D, kvh, hd, out=out)
    assert torch.equal(got[0], ref[0]) and got[1] is out[0]
    for cache, flat, width in ((ck, ref[1], hd), (cks, ref[2], None), (cv, ref[3], hd),
                               (cvs, ref[4], None)):
        shape = (B, T, kvh) + ((width,) if width else ())
        assert torch.equal(cache[:, :, :T], flat.reshape(shape).transpose(1, 2))
        assert (cache[:, :, T:] == (5 if width else 7.0)).all()


# ----------------------------------------------------------- K1 residual


def _weights(seed, n_in, n_out):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_in, n_out)) * 0.05).astype(np.float32)
    return jq.quantize_channel(jnp.asarray(w)), tq.quantize_channel(torch.tensor(w))


def _residual_close(got, want, r, dtype):
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 2.0 ** -23 * (np.abs(r) + np.abs(want))).all()


@pytest.mark.parametrize("m,n_in,n_out", [(20, 96, 130), (64, 256, 384)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_k1_residual_matches_pallas(m, n_in, n_out, dt):
    """w8a8_matmul_prequant(..., residual=) against JAX's residual kernel
    (whose call takes 32-row and 128-column padding)."""
    wj, wt = _weights(m + n_in, n_in, n_out)
    rng = np.random.default_rng(m)
    xq = rng.integers(-127, 128, (m, n_in), dtype=np.int8)
    sx = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
    rj, rt = _pair((rng.standard_normal((m, n_out)) * 3).astype(np.float32), dt)
    mp, ip, op = -(-m // 32) * 32, wj.q.shape[0], wj.q.shape[1]
    want = jm.w8a8_matmul_prequant(
        jnp.asarray(np.pad(xq, ((0, mp - m), (0, ip - n_in)))),
        jnp.asarray(np.pad(sx, (0, mp - m))),
        wj, out_dtype=dt[0], residual=jnp.pad(rj, ((0, mp - m), (0, op - n_out))))
    want = np.asarray(want.astype(jnp.float32))[:m, :n_out]
    got = tm.w8a8_matmul_prequant(torch.tensor(xq), torch.tensor(sx), wt, out_dtype=dt[1],
                                  residual=rt)
    assert got.dtype == dt[1] and got.shape == (m, n_out)
    _residual_close(got.float().numpy(), want, rt.float().numpy(), dt[1])
    mm = tm.w8a8_matmul_prequant(torch.tensor(xq), torch.tensor(sx), wt, out_dtype=dt[1])
    assert torch.equal(got, rt + mm)  # the matmul term rounded first, then added


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_w8a8_matmul_residual_matches_jax(dt):
    """The quantizing wrapper with a residual and leading dims ([B, T, D],
    as the unfused prefill calls it), against JAX's w8a8_matmul."""
    wj, wt = _weights(4, 64, 64)
    rng = np.random.default_rng(5)
    xj, xt = _pair((rng.standard_normal((2, 5, 64)) * 2).astype(np.float32), dt)
    rj, rt = _pair((rng.standard_normal((2, 5, 64)) * 3).astype(np.float32), dt)
    want = np.asarray(jm.w8a8_matmul(xj, wj, out_dtype=dt[0], residual=rj).astype(jnp.float32))
    got = tm.w8a8_matmul(xt, wt, out_dtype=dt[1], residual=rt)
    assert got.shape == (2, 5, 64)
    _residual_close(got.float().numpy(), want, rt.float().numpy(), dt[1])


# ------------------------------------------------------- wrappers, errors


def test_wrappers_run_plain_versions_on_cpu():
    rng = np.random.default_rng(11)
    x = torch.tensor(_rows(rng, 8, 64))
    before, launches = dict(_kernels.PLAIN_CALLS), dict(_kernels.LAUNCHES)
    tq.rmsnorm_quantize(x, torch.ones(64))
    tq.silu_mul_quantize(x[:, :32], x[:, 32:])
    D, _, qkv, cos, sin = _k5_case(1, 8, 1, nh=2, hd=16)
    tq.rope_split_quantize(qkv, torch.tensor(cos), torch.tensor(sin), D, 1, 16)
    for k in ("K3", "K4", "K5"):
        assert _kernels.PLAIN_CALLS[k] == before[k] + 1
    assert _kernels.LAUNCHES == launches


def test_shape_dtype_and_stride_errors_raise():
    x = torch.randn(4, 32)
    with pytest.raises(ValueError):
        tq.rmsnorm_quantize(x, torch.ones(31))
    with pytest.raises(TypeError):
        tq.rmsnorm_quantize(x.to(torch.float16), torch.ones(32))
    gu = torch.randn(4, 64)
    with pytest.raises(ValueError):
        tq.silu_mul_quantize(gu[:, :32], gu[:, 32:48])
    with pytest.raises(ValueError):  # gate's columns are not unit-stride
        tq.silu_mul_quantize(gu[:, ::2], gu[:, 32:])
    with pytest.raises(ValueError):  # gate and up rows lie at different strides
        tq.silu_mul_quantize(gu[:, :32], torch.randn(4, 32))
    with pytest.raises(TypeError):
        tq.silu_mul_quantize(gu[:, :32], gu[:, 32:].to(torch.bfloat16))
    D, _, qkv, cos, sin = _k5_case(2, 8, 1, nh=2, hd=16)
    c, s = torch.tensor(cos), torch.tensor(sin)
    with pytest.raises(ValueError):
        tq.rope_split_quantize(qkv[:, :-2], c, s, D, 1, 16)
    with pytest.raises(ValueError):
        tq.rope_split_quantize(qkv, c[:4], s[:4], D, 1, 16)
    with pytest.raises(TypeError):
        tq.rope_split_quantize(qkv, c.double(), s.double(), D, 1, 16)
    out = [torch.zeros(2, 4, 1, 16, dtype=torch.int8), torch.zeros(2, 4, 1),
           torch.zeros(2, 4, 1, 16, dtype=torch.int8), torch.zeros(2, 4, 1)]
    with pytest.raises(TypeError):
        tq.rope_split_quantize(qkv, c, s, D, 1, 16, out=[out[0].float()] + out[1:])
    with pytest.raises(ValueError):
        tq.rope_split_quantize(qkv, c, s, D, 1, 16, out=[out[0][:1]] + out[1:])
    _, wt = _weights(1, 32, 16)
    with pytest.raises(ValueError):
        tm.w8a8_matmul_prequant(torch.zeros(4, 32, dtype=torch.int8), torch.ones(4), wt,
                                residual=torch.zeros(4, 15))

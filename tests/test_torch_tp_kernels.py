"""Port parity of the tensor-parallel decode's kernels: K21
``flash_decode_attention`` (both forms, INT8, f32 and bf16 caches), K23
``fused_ffn_stacked`` and K24 ``fused_rms_qkv_stacked`` (plain versions)
against the JAX package's Pallas kernels run in interpret mode on the CPU,
as its own tests run them.  Inputs are made with numpy from a seed and
handed to both packages; JAX gets its [L, in, out] weight layout and its
32-row blocks, the port K-major weights.

Limits, and why.

* K21 on an INT8 cache: max |port - jax| <= 2^-8 * max |jax|.  Both sides
  round the scaled query to bf16 for the score dot (exact products, f32
  sums) and p * vs to bf16 before the PV dot -- normalized p in the
  single-pass form, each key block's unnormalized p in the blocked one.
  The f32 sums run in another order (XLA's dots against PyTorch's), a few
  ulps in a score or a denominator, which near a bf16 boundary flips one
  p * vs by one bf16 step (2^-8 of that term); each output is a convex
  combination of V rows, so no output moves by more than 2^-8 of max |out|
  even if every term flipped (the K9 / K19 limit,
  tests/test_torch_decode_attention.py).
* K21 on f32 and bf16 caches: nothing is rounded (bf16 values widen to f32
  exactly), so only the f32 summation order and exp differ: 2^-16 of
  max |jax|.
* K23, K24: every int8 product is exact and every f32 product rounded
  once on both sides, but XLA on the CPU contracts products into FMAs
  inside the interpreted Pallas bodies and approximates rsqrt and exp (the
  known property of K3, K4 and K11, tests/test_torch_fused_quant.py).  A
  moved f32 ulp in the rmsnorm or the SiLU can move one int8 of the row
  quant by one step: the outputs are held within 2^-20 of max |jax| (a few
  f32 ulps of the largest entries) except on rows where such a flip
  happened, which must be at most FLIP_ROWS of the rows and within 2^-6 of
  max |jax| (one int8 step of one input moves an output by at most
  max|w| * sx * sw, ~1/127 of its scale).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import attention as jatt
from tpu_llama.ops import fused_layer as jfl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import fused_layer as tfl
from tpu_llama_torch.ops.quant import ChannelQuantTensor

torch.set_num_threads(1)

INT8_TOL = 2.0 ** -8
FP_TOL = 2.0 ** -16
F32_REL = 2.0 ** -20
FLIP_REL = 2.0 ** -6
FLIP_ROWS = 0.1
POS = (0, 150, 255)  # an empty slot, mid-block, the last row (S - 1)
DTYPES = ("int8", "f32", "bf16")


def _case(seed, dtype, G, hd, L=2, B=3, KVH=2, S=256):
    """(q, k_cache, v_cache, pos, k_scale, v_scale) as numpy arrays; an fp
    cache has no scales (None) and holds bf16-representable values when
    ``dtype`` is bf16 (numpy f32 here; the cache tensors are cast)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    shape = (L, B, KVH, S, hd)
    if dtype == "int8":
        k, v = (rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.03, shape[:-1]).astype(np.float32) for _ in range(2))
        return q, k, v, np.asarray(POS, np.int32), ks, vs
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if dtype == "bf16":
        k, v = (torch.tensor(a).bfloat16().float().numpy() for a in (k, v))
    return q, k, v, np.asarray(POS, np.int32), None, None


def _jax_arrays(arrs, dtype):
    q, k, v, pos, ks, vs = arrs
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    k, v = (jnp.asarray(a, jdt) for a in (k, v))
    return (jnp.asarray(q), k, v, jnp.asarray(pos),
            None if ks is None else jnp.asarray(ks), None if vs is None else jnp.asarray(vs))


def _port_arrays(arrs, dtype):
    q, k, v, pos, ks, vs = arrs
    k, v = (torch.tensor(a) for a in (k, v))
    if dtype == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    return (torch.tensor(q), k, v, torch.tensor(pos),
            None if ks is None else torch.tensor(ks), None if vs is None else torch.tensor(vs))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# -------------------------------------------------------------------- K21


@pytest.mark.parametrize("block_s", [None, 64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,hd", [(1, 64), (2, 32)])
def test_k21_plain_matches_jax_kernel(G, hd, dtype, block_s):
    """Both forms (one key block, the default; blocks of 64 rows) on every
    cache type, at both layers, slots at pos 0, mid-block and S - 1."""
    arrs = _case(21, dtype, G, hd)
    tol = INT8_TOL if dtype == "int8" else FP_TOL
    kernel = _kernels.form("K21", _port_arrays(arrs, dtype)[1].dtype)
    _kernels.reset_counts()
    for layer in range(2):
        want = jatt.flash_decode_attention(*_jax_arrays(arrs, dtype), block_s=block_s,
                                           layer=jnp.int32(layer))
        got = tatt.flash_decode_attention(*_port_arrays(arrs, dtype), block_s=block_s,
                                          layer=layer)
        assert got.dtype == torch.float32
        _close(got.numpy(), want, tol)
    assert _kernels.PLAIN_CALLS[kernel] == 2 and _kernels.LAUNCHES[kernel] == 0


@pytest.mark.parametrize("block_s", [None, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k21_rows_past_pos_are_ignored(dtype, block_s):
    """Rows s <= pos attend: rows past each slot's pos may hold anything
    (int8 127 with scale 1e9, or 1e9 in an fp cache) and the output does
    not move by one bit; the row at pos does count."""
    q, k, v, pos, ks, vs = _port_arrays(_case(5, dtype, 2, 32), dtype)
    clean = tatt.flash_decode_attention(q, k, v, pos, ks, vs, block_s=block_s, layer=1)
    S = k.shape[3]
    past = torch.arange(S)[None, :] > pos[:, None].long()  # [B, S]
    bad = (127 if dtype == "int8" else 1e9)
    for t in (k, v):
        t[1].masked_fill_(past[:, None, :, None], bad)
    for t in (ks, vs):
        if t is not None:
            t[1].masked_fill_(past[:, None, :], 1e9)
    got = tatt.flash_decode_attention(q, k, v, pos, ks, vs, block_s=block_s, layer=1)
    assert torch.equal(got, clean)
    at = torch.arange(S)[None, :] == pos[:, None].long()
    v[1].masked_fill_(at[:, None, :, None], 3 if dtype == "int8" else 3.0)
    moved = tatt.flash_decode_attention(q, k, v, pos, ks, vs, block_s=block_s, layer=1)
    assert not torch.equal(moved, clean)


def test_k21_single_layer_form_and_refusals():
    """A 4-D cache is one layer (attention.py:642-646); a layer outside the
    stack and scales on an fp cache are refused."""
    q, k, v, pos, ks, vs = _port_arrays(_case(3, "int8", 1, 32), "int8")
    whole = tatt.flash_decode_attention(q, k, v, pos, ks, vs, layer=1)
    one = tatt.flash_decode_attention(q, k[1], v[1], pos, ks[1], vs[1])
    assert torch.equal(whole, one)
    with pytest.raises(ValueError, match="layer 2"):
        tatt.flash_decode_attention(q, k, v, pos, ks, vs, layer=2)
    with pytest.raises(ValueError, match="no scales"):
        tatt.flash_decode_attention(q, k.float(), v.float(), pos, ks, vs, layer=0)


# ---------------------------------------------------------------- K23, K24


def _stacked(rng, L, n_in, n_out):
    """Per-channel int8 weights: (q [L, in, out], s [L, out]), the JAX layout."""
    w = rng.standard_normal((L, n_in, n_out)).astype(np.float32) * 0.05
    s = (np.abs(w).max(1) / 127.0).astype(np.float32)
    return np.clip(np.rint(w / s[:, None, :]), -127, 127).astype(np.int8), s


def _port_w(q, s):
    return ChannelQuantTensor(q=torch.tensor(np.ascontiguousarray(np.swapaxes(q, -1, -2))),
                              s=torch.tensor(s))


def _span_case(seed, L=3, B=32, D=256, H=256, QO=384):
    rng = np.random.default_rng(seed)
    return dict(L=L, x=rng.standard_normal((B, D)).astype(np.float32),
                w13=_stacked(rng, L, D, 2 * H), w2=_stacked(rng, L, H, D),
                qkv=_stacked(rng, L, D, QO),
                rf=(1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32),
                ra=(1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32))


def _near_rows(got, want):
    """Within F32_REL of max |want|, except on at most FLIP_ROWS of the rows
    (an int8 step moved upstream), which stay within FLIP_REL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    err = np.abs(got - want).max(axis=1)
    flipped = err > F32_REL * peak
    assert flipped.mean() <= FLIP_ROWS, (flipped.mean(), err.max() / peak)
    assert err.max() <= FLIP_REL * peak, (err.max(), peak)


@pytest.mark.parametrize("layer", [0, 2])
def test_k23_plain_matches_jax(layer):
    """Bp = 32 rows, D = Hl = 256 (the JAX test's widths), layers 0 and
    L - 1: the w2 partial, no residual."""
    c = _span_case(23)
    want = jfl.fused_ffn_stacked(jnp.asarray(c["x"]), *(jnp.asarray(a) for a in c["w13"]),
                                 *(jnp.asarray(a) for a in c["w2"]), jnp.asarray(c["rf"]),
                                 jnp.int32(layer))
    _kernels.reset_counts()
    got = tfl.fused_ffn_stacked(torch.tensor(c["x"]), _port_w(*c["w13"]), _port_w(*c["w2"]),
                                torch.tensor(c["rf"]), layer)
    assert got.dtype == torch.float32 and _kernels.PLAIN_CALLS["K23"] == 1
    _near_rows(got.numpy(), want)


@pytest.mark.parametrize("layer", [0, 2])
def test_k24_plain_matches_jax(layer):
    """Bp = 32 rows, D = 256, QOl = 384, layers 0 and L - 1."""
    c = _span_case(24)
    want = jfl.fused_rms_qkv_stacked(jnp.asarray(c["x"]), *(jnp.asarray(a) for a in c["qkv"]),
                                     jnp.asarray(c["ra"]), jnp.int32(layer))
    _kernels.reset_counts()
    got = tfl.fused_rms_qkv_stacked(torch.tensor(c["x"]), _port_w(*c["qkv"]),
                                    torch.tensor(c["ra"]), layer)
    assert got.dtype == torch.float32 and _kernels.PLAIN_CALLS["K24"] == 1
    _near_rows(got.numpy(), want)


def test_k23_k24_are_k11_phases():
    """K23 + the residual is K11's x_next and K24 of it on layer l + 1 is
    K11's qkv_next, bit for bit (the plain versions share K11's row
    helpers), at 5 rows and at 37 (past one 32-row block)."""
    c = _span_case(11, B=37)
    rng = np.random.default_rng(12)
    wo = _stacked(rng, c["L"], 256, 256)
    x = torch.tensor(c["x"])
    attq = torch.tensor(rng.integers(-127, 128, x.shape, dtype=np.int8))
    satt = torch.tensor(rng.uniform(1e-3, 1e-2, x.shape[0]).astype(np.float32))
    w13, w2, wqkv = (_port_w(*c[k]) for k in ("w13", "w2", "qkv"))
    wo_t = _port_w(*wo)
    rf, ra = torch.tensor(c["rf"]), torch.tensor(c["ra"])
    for B in (5, 37):
        x_next, qkv_next = tfl.fused_layer_linear(x[:B], attq[:B], satt[:B], wo_t, w13, w2,
                                                  wqkv, rf, ra, 1, c["L"])
        x2 = tfl.w8a8_matmul_stacked(attq[:B], satt[:B], wo_t, 1) + x[:B]
        got = x2 + tfl.fused_ffn_stacked(x2, w13, w2, rf, 1)
        assert torch.equal(got, x_next)
        assert torch.equal(tfl.fused_rms_qkv_stacked(got, wqkv, ra, 2), qkv_next)


def test_tp_span_refusals():
    c = _span_case(2, B=4)
    x, w13, w2 = torch.tensor(c["x"]), _port_w(*c["w13"]), _port_w(*c["w2"])
    rf = torch.tensor(c["rf"])
    with pytest.raises(ValueError, match="layer 3"):
        tfl.fused_ffn_stacked(x, w13, w2, rf, 3)
    with pytest.raises(ValueError, match="disagree"):
        tfl.fused_ffn_stacked(x, w13, _port_w(*c["w13"]), rf, 0)
    with pytest.raises(ValueError, match="want x f32"):
        tfl.fused_rms_qkv_stacked(x.double(), _port_w(*c["qkv"]), rf, 0)

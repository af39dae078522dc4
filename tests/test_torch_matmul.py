"""Port parity: K1's plain version equals the JAX package's W8A8 matmul.

``w8a8_matmul`` in both packages quantizes the rows (the JAX package
through quantize_activations_pallas above 256 rows) and runs the int8
product with the epilogue ``(f32(acc) * sx) * sw``; the port's plain
version accumulates exactly in float64.  Results are bit-equal in f32 and
equal in bf16, including widths that are not multiples of 128 (which the
JAX package zero-pads and the port does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import matmul as jm
from tpu_llama.ops import quant as jq
from tpu_llama_torch.ops import matmul as tm
from tpu_llama_torch.ops import quant as tq

torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _weights(seed, n_in, n_out):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_in, n_out)) * 0.05).astype(np.float32)
    return jq.quantize_channel(jnp.asarray(w)), tq.quantize_channel(torch.tensor(w))


@pytest.mark.parametrize("m,n_in,n_out", [(3, 48, 48), (8, 128, 320), (37, 200, 90),
                                          (300, 256, 136)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_w8a8_matmul_equals_jax(m, n_in, n_out, dt):
    wj, wt = _weights(m + n_in, n_in, n_out)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((m, n_in)) * 2).astype(np.float32)
    xj = jnp.asarray(x, dt[0])
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dt[1])
    want = np.asarray(jm.w8a8_matmul(xj, wj, out_dtype=dt[0]).astype(jnp.float32))
    got = tm.w8a8_matmul(xt, wt, out_dtype=dt[1])
    assert got.dtype == dt[1] and got.shape == (m, n_out)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_w8a8_matmul_prequant_equals_jax(dt):
    """K1 alone on pre-quantized rows (the JAX call takes 32-row padding)."""
    wj, wt = _weights(11, 96, 130)
    rng = np.random.default_rng(12)
    xq = rng.integers(-127, 128, (20, 96), dtype=np.int8)
    sx = rng.uniform(1e-3, 1e-1, 20).astype(np.float32)
    want = jm.w8a8_matmul_prequant(jnp.asarray(np.pad(xq, ((0, 12), (0, 32)))),
                                   jnp.asarray(np.pad(sx, (0, 12))), wj, out_dtype=dt[0])
    want = np.asarray(want.astype(jnp.float32))[:20, :130]
    got = tm.w8a8_matmul_prequant(torch.tensor(xq), torch.tensor(sx), wt, out_dtype=dt[1])
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_w8a8_matmul_leading_dims_and_checks():
    _, wt = _weights(13, 64, 32)
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    out = tm.w8a8_matmul(x, wt)
    assert out.shape == (2, 3, 32)
    torch.testing.assert_close(out.reshape(6, 32), tm.w8a8_matmul(x.reshape(6, 64), wt),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        tm.w8a8_matmul_prequant(torch.zeros(4, 63, dtype=torch.int8), torch.ones(4), wt)
    with pytest.raises(TypeError):
        tm.w8a8_matmul_prequant(torch.zeros(4, 64), torch.ones(4), wt)

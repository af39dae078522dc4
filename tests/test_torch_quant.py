"""Port parity: the INT8 quant formats and K2's plain version are
byte-equal to the JAX package.

The JAX package quantizes activations and KV rows inside jit (XLA turns
``absmax / 127`` into ``absmax * f32(1/127)``) and weights eagerly, so the
activation/KV references here run under ``jax.jit`` and the weight
reference eagerly -- each as the JAX model runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import attention as jatt
from tpu_llama.ops import quant as jq
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt
from tpu_llama_torch.ops import quant as tq

torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.05, 20)).astype(np.float32)
    x[0] = 0.0  # an all-zero row: scale 0, q 0
    xj = jnp.asarray(x, dtype[0])
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(dtype[1])


@pytest.mark.parametrize("shape", [(8, 48), (33, 200), (5, 3, 128)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_quantize_activations_bytes_equal_jax(shape, dt):
    xj, xt = _inputs(1, shape, dt)
    qj, sj = jax.jit(jq.quantize_activations)(xj)
    qt, st = tq.quantize_activations(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("rows,cols", [(8, 128), (40, 256), (264, 4096 // 16), (8, 4096)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_k2_plain_bytes_equal_pallas(rows, cols, dt):
    """K2's plain version against quantize_activations_pallas (interpret)."""
    xj, xt = _inputs(2, (rows, cols), dt)
    qj, sj = jq.quantize_activations_pallas(xj)
    qt, st = tq.quantize_activations_plain(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# the card tests' shapes (tests/test_torch_cuda.py test_k2_exact, test_k3_close)
RQ_SHAPES = [(m, 4096) for m in (1, 8, 32, 1000, 2048, 4096)] + [
    (m, n) for m in (1, 5, 33) for n in (11008, 12000)] + [(3, 4104), (1, 7), (3, 100),
                                                          (64, 12000), (33, 11008)]


@pytest.mark.parametrize("m,n", RQ_SHAPES)
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("sms", [132, 114])
def test_rq_plan_covers_every_row_once(m, n, elem, sms):
    """K2's and K3's launch rule (csrc/row_quant.cuh): team ``b * teams +
    i`` of the grid takes rows id, id + stride, ... (stride = grid * teams);
    every row is taken exactly once, no team takes more than
    ``rows_per_team``, the grid stays within its blocks an SM, and a team's
    registers hold the row unless a block cannot."""
    plan = tq.rq_plan(m, n, elem, sms)
    assert plan.warps in (1, 2, 4, 8)
    teams = tq.RQ_WARPS // plan.warps
    stride = plan.grid * teams
    taken = [list(range(i, m, stride)) for i in range(stride)]
    assert sorted(r for t in taken for r in t) == list(range(m))
    assert max(len(t) for t in taken) == plan.rows_per_team
    assert plan.grid == min(-(-m // teams), sms * tq.RQ_GRID_PER_SM)
    nvec = -(-n * elem // 16)
    held = 32 * plan.warps * tq.RQ_VECS
    assert nvec <= held or plan.warps == tq.RQ_WARPS
    if plan.warps > 1:  # fewer warps would hold the row: m is small
        assert nvec > held // 2 or m * plan.warps // 2 < sms * tq.RQ_WARPS
    with pytest.raises(ValueError):
        tq.rq_plan(0, n, elem, sms)


def test_rq_plan_constants_match_row_quant_header():
    """rq_plan's block layout is the one K2 and K3 are built with: RQ_WARPS
    and RQ_VECS are row_quant.cuh's kRqWarps and kRqVecs (on the card the
    wrappers also ask the built library, ``tl_row_quant_layout``)."""
    import re
    from pathlib import Path

    src = (Path(tq.__file__).resolve().parent.parent / "csrc" / "row_quant.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (kRq\w+) = (\d+);", src, re.M))
    assert int(consts["kRqWarps"]) == tq.RQ_WARPS
    assert int(consts["kRqVecs"]) == tq.RQ_VECS


def test_rq_plan_shapes():
    """Two warps a 7B bf16 row and one row a team on the admission's, a
    chunk's and a wave's rows, whole blocks on a decode step's, teams walking
    rows by stride past 8 blocks an SM."""
    P = tq.RowQuantPlan
    assert tq.rq_plan(4096, 4096, 2, 132) == P(2, 1024, 1)
    assert tq.rq_plan(2048, 4096, 2, 132) == P(2, 512, 1)
    assert tq.rq_plan(8, 4096, 2, 132) == P(8, 8, 1)
    assert tq.rq_plan(4096, 4096, 4, 132) == P(4, 1056, 2)
    assert tq.rq_plan(4096, 11008, 2, 132) == P(8, 1056, 4)
    assert tq.rq_plan(1000, 4096, 2, 132) == P(2, 250, 1)
    assert tq.rq_plan(16384, 4096, 2, 132) == P(2, 1056, 4)


def test_k2_wrapper_runs_plain_on_cpu():
    _, xt = _inputs(3, (16, 64), DTYPES[1])
    before = dict(_kernels.PLAIN_CALLS)
    launches = dict(_kernels.LAUNCHES)
    q, s = tq.quantize_activations(xt)
    assert _kernels.PLAIN_CALLS["K2"] == before["K2"] + 1
    assert _kernels.LAUNCHES == launches
    q2, s2 = tq.quantize_activations_plain(xt)
    assert torch.equal(q, q2) and torch.equal(s, s2)


@pytest.mark.parametrize("shape", [(2, 5, 4, 16), (3, 2, 128)])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "bf16"])
def test_quantize_kv_bytes_equal_jax(shape, dt):
    xj, xt = _inputs(4, shape, dt)
    qj, sj = jax.jit(jatt.quantize_kv)(xj)
    qt, st = tatt.quantize_kv(xt)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape", [(48, 128), (2, 48, 130), (256, 320)])
def test_quantize_channel_bytes_equal_jax(shape):
    """Weights: eager JAX, unpadded and K-major in the port."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column
    tj = jq.quantize_channel(jnp.asarray(w))
    tt = tq.quantize_channel(torch.tensor(w))
    n_in, n_out = shape[-2:]
    assert tt.q.shape == (*shape[:-2], n_out, n_in) and tt.q.is_contiguous()
    np.testing.assert_array_equal(tt.q.numpy(),
                                  np.swapaxes(np.asarray(tj.q)[..., :n_in, :n_out], -1, -2))
    np.testing.assert_array_equal(tt.s.numpy(), np.asarray(tj.s)[..., :n_out])
    np.testing.assert_array_equal(tq.dequantize_channel(tt).numpy(),
                                  np.asarray(jq.dequantize_channel(tj)))

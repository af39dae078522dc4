"""The host-side rules of K1's and K29's CUDA kernels, through their pure
Python mirrors in tpu_llama_torch/ops/matmul.py, and the K padding K1's
wgmma form takes, against the JAX package's ``w8a8_matmul_prequant``.

The kernels compute these rules themselves (csrc/w8a8_matmul.cu dispatch
and w8a8_wgmma_kernel's raster; csrc/w8a8_rows_resident.cu plan_for,
ring_stages and launch); the mirrors state them where the CPU can hold
them: every output tile of the wgmma kernel is owned by exactly one block
at the served shapes, K29's slice and ring fit in a block's 232448 bytes
of shared memory, and its grid covers every (m-block, weight tile) pair
exactly once.  The padding of K with zero columns leaves every int32 sum,
and so the plain version's result, unchanged bit for bit; the JAX
function's result on the unpadded operands is the reference (its Pallas
kernel in interpret mode on the CPU, exact int32 sums and the same
epilogue).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import matmul as jm
from tpu_llama.ops import quant as jq
from tpu_llama_torch.ops import matmul as tm
from tpu_llama_torch.ops import quant as tq

# Llama-2 7B's output widths: wqkv, wo / w2, w13, wcls, w1 (unfused), and
# a ragged width against the 256-column tile
N_7B = (12288, 4096, 22016, 32000, 11008)


@pytest.mark.parametrize("m", [17, 1000, 2048, 4096])
@pytest.mark.parametrize("n", N_7B + (4000,))
def test_k1_raster_visits_every_tile_once(m, n):
    plan = tm.w8a8_plan(m, 4096, n)
    order = tm.w8a8_raster(m, n)
    bm, bn, _ = tm.W8A8_TILE
    tiles = {(i, j) for i in range(-(-m // bm)) for j in range(-(-n // bn))}
    assert plan.form == "wgmma" and len(order) == plan.blocks == len(tiles)
    assert set(order) == tiles


def test_k1_raster_groups_column_blocks():
    """Blocks side by side share an m-block across a group of
    W8A8_GROUP_N column blocks, and a group's m-blocks follow one another:
    the W tiles of a group stay in L2 while its m-blocks pass."""
    order = tm.w8a8_raster(4096, 22016)  # 32 m-blocks, 86 column blocks
    g = tm.W8A8_GROUP_N
    assert order[:g] == [(0, j) for j in range(g)]
    assert order[g:2 * g] == [(1, j) for j in range(g)]
    assert {nb for _, nb in order[:32 * g]} == set(range(g))
    last = order[(86 // g) * 32 * g:]  # the last group: 86 % 16 = 6 column blocks
    assert last[:6] == [(0, 80 + j) for j in range(6)] and len(last) == 32 * 6


@pytest.mark.parametrize("m,k,n,form,kp", [
    (1, 4096, 12288, "decode", 4096), (16, 4096, 32000, "decode", 4096),
    (16, 40, 50, "decode", 40), (17, 4096, 32000, "wgmma", 4096), (32, 4096, 12288, "wgmma", 4096),
    (17, 40, 50, "wgmma", 48), (300, 96, 136, "wgmma", 96), (129, 4112, 4000, "wgmma", 4112),
    (4096, 11008, 4096, "wgmma", 11008), (64, 1, 8, "wgmma", 16)])
def test_k1_plan(m, k, n, form, kp):
    """The decode tile up to 16 rows, any K; the wgmma tile above, K padded
    to a multiple of 16 (TMA's stride)."""
    plan = tm.w8a8_plan(m, k, n)
    assert (plan.form, plan.k) == (form, kp)
    rows, cols, _ = plan.tile
    assert plan.tile == (tm.W8A8_DECODE_TILE if form == "decode" else tm.W8A8_TILE)
    assert plan.blocks == -(-m // rows) * -(-n // cols)


@pytest.mark.parametrize("m,k,n", [(17, 40, 50), (33, 1, 24), (40, 100, 130), (20, 1000, 64)])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dt", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_k1_k_padding_leaves_the_product(m, k, n, residual, dt):
    """Zero columns appended to x and W, as the wgmma form's wrapper appends
    them, leave the plain version's result unchanged bit for bit; both equal
    JAX's on the unpadded operands (its call pads rows to 32 and columns to
    128, then slices)."""
    rng = np.random.default_rng(m * 1000 + k)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    wj, wt = jq.quantize_channel(jnp.asarray(w)), tq.quantize_channel(torch.tensor(w))
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    sx = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
    r = np.asarray(jnp.asarray(rng.standard_normal((m, n)).astype(np.float32) * 3)
                   .astype(dt[0]).astype(jnp.float32)) if residual else None
    rt = None if r is None else torch.tensor(r).to(dt[1])
    kp = tm.w8a8_plan(m, k, n).k
    assert kp % 16 == 0 and 0 <= kp - k < 16
    got = tm.w8a8_matmul_prequant_plain(torch.tensor(xq), torch.tensor(sx), wt, dt[1], rt)
    padded = tq.ChannelQuantTensor(q=torch.nn.functional.pad(wt.q, (0, kp - k)), s=wt.s)
    got_p = tm.w8a8_matmul_prequant_plain(torch.nn.functional.pad(torch.tensor(xq), (0, kp - k)),
                                          torch.tensor(sx), padded, dt[1], rt)
    assert torch.equal(got, got_p)
    mp, ip, op = -(-m // 32) * 32, wj.q.shape[0], wj.q.shape[1]
    want = jm.w8a8_matmul_prequant(
        jnp.asarray(np.pad(xq, ((0, mp - m), (0, ip - k)))), jnp.asarray(np.pad(sx, (0, mp - m))),
        wj, out_dtype=dt[0],
        residual=None if r is None else jnp.pad(jnp.asarray(r).astype(dt[0]),
                                                ((0, mp - m), (0, op - n))))
    want = np.asarray(want.astype(jnp.float32))[:m, :n]
    if residual and dt[1] == torch.float32:  # XLA on the CPU contracts r + mm into an FMA
        assert np.abs(got.numpy() - want).max() <= 2.0 ** -22 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("n_in,want", [
    (16, (32, 4)), (48, (32, 4)), (256, (32, 4)), (4096, (32, 4)), (4112, (32, 4)),
    (5120, (32, 4)), (5136, (32, 2)), (5952, (32, 2)), (6144, (32, 2)), (6160, (16, 4)),
    (10240, (16, 4)), (10256, (16, 2)), (11008, (16, 2)), (11904, (16, 2)), (12288, (16, 2))])
def test_k29_plan_fits_shared_memory(n_in, want):
    """The first of (32 rows, 4 consumers), (32, 2), (16, 4), (16, 2) with
    two or more stages beside the slice; the ring 2-8 stages deep; the whole
    block within 232448 bytes, and one more stage would not fit (below the
    cap of 8)."""
    plan = tm.rows_resident_plan(n_in)
    assert (plan.bm, plan.consumers) == want and tm.rows_resident_bm(n_in) == plan.bm
    assert 2 <= plan.stages <= 8 and plan.rows == 64 * plan.consumers
    smem = tm.rows_resident_smem(plan.bm, n_in, plan.consumers, plan.stages)
    assert smem <= 232448
    assert plan.stages == 8 or \
        tm.rows_resident_smem(plan.bm, n_in, plan.consumers, plan.stages + 1) > 232448
    for bm, cons in tm._RESIDENT_ORDER[:tm._RESIDENT_ORDER.index(want)]:  # those preferred
        assert tm.rows_resident_smem(bm, n_in, cons, 2) > 232448


@pytest.mark.parametrize("n_in", [0, 8, 40, 200, 4100, 12304, 16384])
def test_k29_plan_refuses(n_in):
    """Not a multiple of 16 (TMA's stride), or a slice of 16 rows too wide
    for two stages beside it."""
    assert tm.rows_resident_plan(n_in).bm == 0 and tm.rows_resident_bm(n_in) == 0


@pytest.mark.parametrize("m,n_in,n", [(4096, 4096, 12288), (4096, 11008, 4096), (1000, 4096, 4096),
                                      (2048, 4096, 22016), (300, 4096, 384), (260, 48, 40),
                                      (4100, 11008, 4096), (1000, 6160, 1000)])
@pytest.mark.parametrize("cluster", tm.RESIDENT_CLUSTERS)
def test_k29_grid_covers_each_tile_once(m, n_in, n, cluster):
    """Every (m-block, weight tile) pair of the product is computed by
    exactly one block; the m-blocks are a whole number of clusters, those
    past M hold no rows; splits along y never exceed the tiles."""
    plan = tm.rows_resident_plan(n_in)
    nm, split = tm.rows_resident_grid(m, n, plan, cluster)
    tiles = -(-n // plan.rows)
    assert nm % cluster == 0 and nm - cluster < -(-m // plan.bm) <= nm and 1 <= split <= tiles
    seen = [(x, t) for x, y in itertools.product(range(nm), range(split))
            for t in range(y, tiles, split) if x * plan.bm < m]
    assert len(seen) == len(set(seen)) == -(-m // plan.bm) * tiles


@pytest.mark.parametrize("m,bm,want", [(4096, 32, tm.ROWS_RESIDENT_CLUSTER), (257, 32, 8),
                                       (300, 16, 8), (40, 32, 2), (16, 16, 1)])
def test_k29_cluster(m, bm, want):
    """ROWS_RESIDENT_CLUSTER blocks a cluster, halved while it exceeds the
    m-blocks."""
    assert tm.rows_resident_cluster(m, bm) == min(want, tm.ROWS_RESIDENT_CLUSTER)
    assert tm.rows_resident_cluster(m, bm) in tm.RESIDENT_CLUSTERS

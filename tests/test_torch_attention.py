"""Port parity: K6's plain version against the JAX package's prefill
attention, the port's ``attention_prefill`` against its ``attn="xla"``
math, and K7's plain version against its slot scatter.

K6 tolerances (of max |jax|), read over seeds 1-5 of these cases:

* K6's plain version is the TPU kernels' function, q and p * vs rounded
  to bf16 before the dots (csrc/prefill_mma.cuh), in the CUDA cell's order:
  an online softmax over 64-key tiles.  Where the JAX kernel's walk sees
  one key block (block_s 32 here) and the cell one tile, both are one pass
  with the full row max (``_flash_prefill_fresh_kernel``'s arithmetic):
  f32 summation noise, K6_ONE_BLOCK_TOL = 1e-6 (readings up to 4.0e-7).
  Over several blocks each rounds p * vs at its own running max, a bf16
  rounding at another scale: K6_TOL = 4e-3 (readings up to 1.5e-3).
* ``attention_prefill`` against ``_attention_prefill`` (f32 on the
  dequantized cache, the math the JAX package's CPU engine runs): f32
  summation noise, 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.config import ModelConfig
from tpu_llama.models.llama import _attention_prefill
from tpu_llama.ops import attention as jatt
from tpu_llama_torch.models import llama as tl
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

K6_ONE_BLOCK_TOL = 1e-6
K6_TOL = 4e-3


def _case(seed, B, T, NH, KVH, S, hd, start):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, NH, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (B, KVH, S, hd), dtype=np.int8)
    v = rng.integers(-127, 128, (B, KVH, S, hd), dtype=np.int8)
    ks = rng.uniform(0.005, 0.03, (B, KVH, S)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, (B, KVH, S)).astype(np.float32)
    st = np.asarray(start, np.int32)
    return q, k, v, st, ks, vs


CASES = [  # (B, T, NH, KVH, S, hd, start)
    (2, 16, 4, 2, 16, 16, [0, 0]),        # fresh GQA, S == T
    (2, 24, 4, 1, 64, 32, [0, 0]),        # GQA 4:1, S > T
    (3, 8, 4, 2, 64, 16, [5, 0, 40]),     # start > 0 (continue-style)
    (1, 40, 2, 2, 128, 8, [70]),          # MHA, several key blocks
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"B{c[0]}T{c[1]}G{c[2] // c[3]}")
def test_k6_plain_matches_jax_kernel(case):
    arrs = _case(1, *case)
    q, k, v, st, ks, vs = arrs
    fresh = not st.any() and case[4] == case[1]
    want = np.asarray(jatt.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
        jnp.asarray(ks), jnp.asarray(vs), block_q=32, block_s=32, assume_fresh=fresh))
    got = tatt.flash_prefill_attention(*(torch.tensor(a) for a in arrs)).numpy()
    assert got.shape == want.shape == (case[0], case[1], case[2] * case[5])
    one_block = max(st) + case[1] <= 32  # every attended key in the JAX kernel's first block
    tol = K6_ONE_BLOCK_TOL if one_block else K6_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"B{c[0]}T{c[1]}G{c[2] // c[3]}")
def test_k6_plain_matches_jax_f32_path(case):
    q, k, v, st, ks, vs = _case(2, *case)
    B, T, NH, KVH, S, hd, _ = case
    cfg = ModelConfig(dim=NH * hd, hidden_dim=8, n_layers=1, n_heads=NH, n_kv_heads=KVH,
                      vocab_size=8, seq_len=S)
    kf = jnp.asarray(k).astype(jnp.float32) * jnp.asarray(ks)[..., None]
    vf = jnp.asarray(v).astype(jnp.float32) * jnp.asarray(vs)[..., None]
    q_pos = jnp.asarray(st)[:, None] + jnp.arange(T)[None, :]
    want = np.asarray(_attention_prefill(jnp.asarray(q), kf, vf, q_pos, cfg, "highest"))
    got = tl.attention_prefill(*(torch.tensor(a) for a in (q, k, v, st, ks, vs))).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_k6_wrapper_checks_and_out_dtype():
    arrs = [torch.tensor(a) for a in _case(3, 1, 8, 2, 2, 8, 8, [0])]
    before = _kernels.PLAIN_CALLS["K6"]
    out = tatt.flash_prefill_attention(*arrs, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and _kernels.PLAIN_CALLS["K6"] == before + 1
    q, k, v, st, ks, vs = arrs
    with pytest.raises(ValueError):  # an fp cache has no scales
        tatt.flash_prefill_attention(q, k.float(), v.float(), st, ks, vs)
    with pytest.raises(ValueError):
        tatt.flash_prefill_attention(q, k, v, st, ks[:, :, :4], vs)


@pytest.mark.parametrize("T,S,slots", [(16, 64, [3, 0]), (128, 128, [1, 2, 0]),
                                       (8, 8, [2])])
def test_k7_plain_equals_jax(T, S, slots):
    rng = np.random.default_rng(T + S)
    L, KVH, hd, B = 2, 2, 16, 4
    n = len(slots)
    small = [rng.integers(-127, 128, (L, n, KVH, T, hd), dtype=np.int8) for _ in range(2)]
    small_s = [rng.uniform(0, 1, (L, n, KVH, T)).astype(np.float32) for _ in range(2)]
    cache = [rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8) for _ in range(2)]
    cache_s = [rng.uniform(0, 1, (L, B, KVH, S)).astype(np.float32) for _ in range(2)]
    want = jatt.kv_cache_scatter_slots(
        jnp.asarray(small[0]), jnp.asarray(small[1]), jnp.asarray(slots, jnp.int32),
        jnp.asarray(cache[0]), jnp.asarray(cache[1]), jnp.asarray(small_s[0]),
        jnp.asarray(small_s[1]), jnp.asarray(cache_s[0]), jnp.asarray(cache_s[1]))
    ck, cv, cks, cvs = (torch.tensor(a) for a in (*cache, *cache_s))
    got = tatt.kv_cache_scatter_slots(
        torch.tensor(small[0]), torch.tensor(small[1]), torch.tensor(slots), ck, cv,
        torch.tensor(small_s[0]), torch.tensor(small_s[1]), cks, cvs)
    for g, orig, w in zip(got, (ck, cv, cks, cvs), want):
        assert g is orig  # written in place
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k7_rejects_bad_slots():
    L, n, KVH, T, hd, B, S = 1, 2, 1, 4, 8, 3, 8
    sk = torch.zeros(L, n, KVH, T, hd, dtype=torch.int8)
    ss = torch.zeros(L, n, KVH, T)
    ck = torch.zeros(L, B, KVH, S, hd, dtype=torch.int8)
    cs = torch.zeros(L, B, KVH, S)
    for bad in ([0, 3], [1, 1], [-1, 0], [0]):
        with pytest.raises(ValueError):
            tatt.kv_cache_scatter_slots(sk, sk, torch.tensor(bad), ck, ck.clone(), ss, ss,
                                        cs, cs.clone())
    big = torch.zeros(L, n, KVH, S + 1, hd, dtype=torch.int8)
    bigs = torch.zeros(L, n, KVH, S + 1)
    with pytest.raises(ValueError):
        tatt.kv_cache_scatter_slots(big, big, torch.tensor([0, 1]), ck, ck.clone(), bigs,
                                    bigs, cs, cs.clone())

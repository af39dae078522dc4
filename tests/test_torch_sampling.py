"""Port parity of device sampling: the threefry key stream and the three
samplers of ``tpu_llama_torch.ops.sampling`` against ``jax.random`` and
``tpu_llama.ops.sampling`` on the same logits (numpy, from a seed).

The random bits must be equal exactly: ``key``, ``fold_in`` and ``uniform``
hold JAX's 32-bit seed handling and its partitionable threefry layout.  The
sampled tokens must be equal too.  The softmax and the masked sums of
``sample_nosort``'s bisection run in another order in PyTorch than in XLA,
so at a cutoff tie the two could keep different sets; on these seeds they
do not, and a failure on a fixed seed is a fault, not noise.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import sampling as jsamp
from tpu_llama_torch.ops import sampling as ts

torch.set_num_threads(1)

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 + 5]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_equal_jax(seed):
    jk = jax.random.key(seed)
    np.testing.assert_array_equal(ts.key(seed).numpy(), np.asarray(jax.random.key_data(jk)))
    for d in (0, 5, 2047, 2 ** 31 - 1):
        np.testing.assert_array_equal(ts.fold_in(ts.key(seed), d).numpy(),
                                      np.asarray(jax.random.key_data(jax.random.fold_in(jk, d))))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(32000,), (7,)])
def test_uniform_bits_equal_jax(seed, shape):
    jk = jax.random.key(seed)
    want = jax.random.uniform(jk, shape, minval=1e-20, maxval=1.0)
    got = ts.uniform(ts.key(seed), shape, minval=1e-20, maxval=1.0)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(ts.uniform(ts.key(seed), shape).numpy()),
                                  _bits(jax.random.uniform(jk, shape)))


def test_per_row_keys_equal_jax():
    """Per-row keys [8]: vmapped fold_in with int32 positions, then each
    row's own (V,) draw, as the engine's sampling steps do."""
    seeds = [3, 1000, 2 ** 31 - 1, 7, 0, 2 ** 32 + 5, 11, 12]
    pos = np.array([0, 1, 127, 128, 511, 1000, 1900, 2047], np.int32)
    jkeys = jax.vmap(jax.random.fold_in)(jnp.stack([jax.random.key(s) for s in seeds]),
                                         jnp.asarray(pos))
    tkeys = ts.fold_in(torch.tensor(ts.keys_numpy(seeds)), torch.tensor(pos))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jax.random.key_data(jkeys)))
    want = jax.vmap(lambda k: jax.random.uniform(k, (32000,), minval=1e-20, maxval=1.0))(jkeys)
    got = ts.uniform(tkeys, (32000,), minval=1e-20, maxval=1.0)
    assert got.shape == (8, 32000)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


COMBOS = list(itertools.product([0.0, 0.8, 1.3], [1.0, 0.9], [0, 40]))  # temp, top-p, top-k


def _logits(B, V, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, V)) * rng.uniform(0.5, 4.0, (B, 1))).astype(np.float32)
    x[6, [3, 9]] = x[6].max() + 1.0  # a tie at the max: the lowest index wins
    return x


@pytest.mark.parametrize("V", [32000, 517])
@pytest.mark.parametrize("name", ["sample", "sample_nosort"])
@pytest.mark.parametrize("half", [0, 1])
def test_samplers_equal_jax(V, name, half):
    """B 8 rows, per-row keys and per-row (temperature, top-p, top-k): the
    two halves cover the 12 combinations, row 6 greedy on a tie; then the
    same logits under one key for the whole batch."""
    B = 8
    combos = (COMBOS[:6] + COMBOS[:2]) if half == 0 else (COMBOS[6:] + COMBOS[:2])
    temps, topps, topks = (np.array(c, dt) for c, dt in
                           zip(zip(*combos), (np.float32, np.float32, np.int32)))
    x = _logits(B, V, seed=V + half)
    seeds = [100 + i + 10 * half for i in range(B)]
    pos = np.arange(B, dtype=np.int32) * 37 + half
    jkeys = jax.vmap(jax.random.fold_in)(jnp.stack([jax.random.key(s) for s in seeds]),
                                         jnp.asarray(pos))
    tkeys = ts.fold_in(torch.tensor(ts.keys_numpy(seeds)), torch.tensor(pos))
    jfn, tfn = getattr(jsamp, name), getattr(ts, name)
    want = np.asarray(jfn(jnp.asarray(x), jkeys, jnp.asarray(temps), jnp.asarray(topps),
                          jnp.asarray(topks)))
    got = tfn(torch.tensor(x), tkeys, torch.tensor(temps), torch.tensor(topps),
              torch.tensor(topks)).numpy()
    np.testing.assert_array_equal(got, want)
    assert temps[6] == 0 and got[6] == 3  # row 6 is greedy: the first of the two maxima
    one = jax.random.fold_in(jax.random.key(5), 17)
    want1 = np.asarray(jfn(jnp.asarray(x), one, jnp.asarray(temps), jnp.asarray(topps),
                           jnp.asarray(topks)))
    got1 = tfn(torch.tensor(x), ts.fold_in(ts.key(5), 17), torch.tensor(temps),
               torch.tensor(topps), torch.tensor(topks)).numpy()
    np.testing.assert_array_equal(got1, want1)


def test_greedy_equals_jax_and_scalar_params():
    x = _logits(8, 517, seed=3)
    np.testing.assert_array_equal(ts.greedy(torch.tensor(x)).numpy(),
                                  np.asarray(jsamp.greedy(jnp.asarray(x))))
    keys = ts.fold_in(torch.tensor(ts.keys_numpy(range(8))), 4)
    jkeys = jax.vmap(jax.random.fold_in)(jnp.stack([jax.random.key(s) for s in range(8)]),
                                         jnp.full((8,), 4, jnp.int32))
    got = ts.sample_nosort(torch.tensor(x), keys, 0.7, 0.95, 0).numpy()
    want = np.asarray(jsamp.sample_nosort(jnp.asarray(x), jkeys, 0.7, 0.95, 0))
    np.testing.assert_array_equal(got, want)

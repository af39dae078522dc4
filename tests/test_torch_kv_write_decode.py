"""Port parity of K28 ``kv_cache_write_decode`` (plain version) against the
JAX package's Pallas kernel run in interpret mode, as its own tests run it
on the CPU: byte-equal on INT8, float32 and bfloat16 caches.

Limits: none -- the write is a copy of values the plain version computes
as the JAX kernel does.  For an INT8 cache the scale is the jitted form
absmax * f32(1/127) (XLA's rewrite of the kernel's absmax / 127: the rows
here include ones where the two differ, and the bytes equal JAX's only with
the product), then rint(x * (1 / s)) clipped to +-127; an fp cache takes
the f32 value rounded to its dtype.  JAX leaves a pos outside [0, S)
undefined; the port skips such a slot (as its K10 does), held here on the
port alone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpu_llama.ops import attention as jatt
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

SPLIT = np.float32(1.0090004205703735)  # f32(SPLIT / 127) != SPLIT * f32(1 / 127)
CACHE = {"int8": (np.int8, torch.int8), "float32": (np.float32, torch.float32),
         "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(seed, kv, L=3, B=4, KVH=8, S=16, hd=128, pos=(0, 5, 15, 9)):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, KVH, hd)) * 3).astype(np.float32)
    v = (rng.standard_normal((B, KVH, hd)) * 3).astype(np.float32)
    k[1, 2] = 0.0  # a zero row: scale 0, values 0
    # a row whose absmax / 127 and absmax * f32(1/127) differ in the last bit
    k[0, 1] = np.clip(k[0, 1], -1.0, 1.0)
    k[0, 1, 3] = SPLIT
    if kv == "int8":
        ck = rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8)
        cv = rng.integers(-127, 128, (L, B, KVH, S, hd), dtype=np.int8)
        cks = rng.uniform(0.01, 0.02, (L, B, KVH, S)).astype(np.float32)
        cvs = rng.uniform(0.01, 0.02, (L, B, KVH, S)).astype(np.float32)
    else:
        ck = rng.standard_normal((L, B, KVH, S, hd)).astype(np.float32)
        cv = rng.standard_normal((L, B, KVH, S, hd)).astype(np.float32)
        cks = cvs = None
    return k, v, np.array(pos, np.int32), ck, cv, cks, cvs


def _as_bytes(a):
    return np.asarray(a).view(np.uint8) if np.asarray(a).dtype != np.float32 else \
        np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("layer", [0, 2])
@pytest.mark.parametrize("kv", list(CACHE))
def test_k28_plain_equals_jax(kv, layer):
    k, v, pos, ck, cv, cks, cvs = _case(10 + layer, kv)
    jdt, tdt = CACHE[kv]
    scaled = cks is not None
    jargs = [jnp.asarray(ck).astype(jdt), jnp.asarray(cv).astype(jdt)]
    targs = [torch.tensor(np.asarray(a, np.float32)).to(tdt) for a in (ck, cv)]
    if scaled:
        jargs += [jnp.asarray(cks), jnp.asarray(cvs)]
        targs += [torch.tensor(cks), torch.tensor(cvs)]
        assert SPLIT / np.float32(127) != SPLIT * np.float32(1 / 127)
    want = jatt.kv_cache_write_decode(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                      jnp.int32(layer), *jargs)
    _kernels.reset_counts()
    got = tatt.kv_cache_write_decode(torch.tensor(k), torch.tensor(v), torch.tensor(pos), layer,
                                     *targs)
    assert _kernels.PLAIN_CALLS[_kernels.form("K28", tdt)] == 1
    assert not any(_kernels.LAUNCHES.values())
    assert len(got) == len(want) == (4 if scaled else 2)
    for g, t, w in zip(got, targs, want):
        assert g is t  # written in place
        w = np.asarray(w.astype(jnp.float32) if kv == "bfloat16" and w.dtype != jnp.float32
                       else w)
        gn = g.float().numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(_as_bytes(gn), _as_bytes(w))
    if scaled:  # the zero row: scale 0 and values 0
        assert float(got[2][layer, 1, 2, pos[1]]) == 0.0
        assert not got[0][layer, 1, 2, pos[1]].any()


@pytest.mark.parametrize("kv", list(CACHE))
def test_k28_skips_slots_outside_the_cache(kv):
    """A slot at pos S or below 0 writes nothing (JAX leaves it undefined);
    the others are written; nothing else moves."""
    k, v, pos, ck, cv, cks, cvs = _case(20, kv, pos=(16, 3, -1, 7))
    tdt = CACHE[kv][1]
    arrs = [torch.tensor(np.asarray(a, np.float32)).to(tdt) for a in (ck, cv)]
    if cks is not None:
        arrs += [torch.tensor(cks), torch.tensor(cvs)]
    before = [a.clone() for a in arrs]
    tatt.kv_cache_write_decode(torch.tensor(k), torch.tensor(v), torch.tensor(pos), 1, *arrs)
    for a, b in zip(arrs, before):
        changed = (a != b).reshape(a.shape[0], a.shape[1], a.shape[2], a.shape[3], -1).any(-1)
        assert not changed[:, [0, 2]].any()  # the slots outside [0, S)
        assert not changed[[0, 2]].any()  # the other layers
        rows = changed[1, [1, 3]]  # the written slots: only their row at pos
        assert not rows[0, :, torch.arange(16) != 3].any()
        assert not rows[1, :, torch.arange(16) != 7].any()
    want = tatt.kv_cache_write_decode_plain(
        torch.tensor(k[[1, 3]]), torch.tensor(v[[1, 3]]), torch.tensor([3, 7]), 1,
        *[b[:, [1, 3]].clone() for b in before])
    for a, w in zip(arrs, want):
        assert torch.equal(a[:, [1, 3]], w)


def test_k28_rejects_what_it_does_not_take():
    k, v, pos, ck, cv, cks, cvs = _case(30, "int8")
    args = [torch.tensor(a) for a in (k, v, pos)]
    cache = [torch.tensor(a) for a in (ck, cv, cks, cvs)]
    with pytest.raises(ValueError):  # layer outside the cache
        tatt.kv_cache_write_decode(*args, 3, *cache)
    with pytest.raises(ValueError):  # an INT8 cache without its scales
        tatt.kv_cache_write_decode(*args, 0, *cache[:2])
    with pytest.raises(ValueError):  # rows of another width
        tatt.kv_cache_write_decode(args[0][..., :64], args[1][..., :64], args[2], 0, *cache)

"""The page-block split cell of K20 and K22 (csrc/decode_split_page.cuh) on
the CPU: their plain versions against the JAX package's
``paged_flash_decode_attention_fresh`` and ``paged_flash_decode_attention``
(Pallas in interpret mode) at one, two and four runs of whole pages, at a
page of 16 rows and one of 512; empty splits; rows no slot attends
poisoned; the split rule and the ring tile's rows.

Tolerances: at one split the plain versions walk JAX's blocks (whole pages)
with its roundings at its points, and sum in another f32 order: within
1e-6 of max |jax|.  At more than one split each p is rounded, as
bf16(p * vs), against its split's running max instead of the whole walk's,
which moves that term by at most one bf16 step; an output is a convex
combination of V rows, so no output moves by more than 2^-8 of max |out|
(tests/test_torch_decode_split.py's limit and reason).  Everything else is
bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_llama.ops import attention as jatt
from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops import attention as tatt

torch.set_num_threads(1)

ONE_TOL = 1e-6
SPLIT_TOL = 2.0 ** -8
# pages of 16 rows (MP 8) and of 512 (MP 4, the 7B pools' size): pos on a
# page boundary, inside a page, inside a later run of pages, the last row
SHAPES = {16: (8, (16, 37, 77, 127)), 512: (4, (512, 700, 1100, 2047))}
NAMES = {"K20": "paged_flash_decode_attention_fresh", "K22": "paged_flash_decode_attention"}


def _case(seed, G, ps, hd=16, L=2, B=4, KVH=2):
    """(q, k_pool, v_pool, k_scale, v_scale, page_table, pos, new_k, new_v,
    new_ks, new_vs) as numpy arrays in the wrappers' order: each slot's MP
    pages drawn out of order from a pool of B * MP + 1 (page 0 unused)."""
    MP, pos = SHAPES[ps]
    rng = np.random.default_rng(seed)
    P = B * MP + 1
    q = rng.standard_normal((B, KVH, G, hd)).astype(np.float32)
    k, v = (rng.integers(-127, 128, (L, P, KVH, ps, hd), dtype=np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.03, (L, P, KVH, ps)).astype(np.float32) for _ in range(2))
    pt = (1 + rng.permutation(B * MP)).reshape(B, MP).astype(np.int32)
    nk, nv = (rng.integers(-127, 128, (B, KVH, hd), dtype=np.int8) for _ in range(2))
    nks, nvs = (rng.uniform(0.005, 0.03, (B, KVH)).astype(np.float32) for _ in range(2))
    return q, k, v, ks, vs, pt, np.asarray(pos, np.int32), nk, nv, nks, nvs


def _args(kernel, arrs):
    return arrs if kernel == "K20" else arrs[:7]


@functools.lru_cache(maxsize=None)
def _jax(kernel, G, ps, layer):
    arrs = _args(kernel, _case(150 + G + ps, G, ps))
    return np.asarray(getattr(jatt, NAMES[kernel])(*(jnp.asarray(a) for a in arrs),
                                                   layer=jnp.int32(layer)))


def _port(kernel, arrs, **kw):
    return getattr(tatt, NAMES[kernel])(*(torch.tensor(a) for a in _args(kernel, arrs)), **kw)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("ps", [16, 512])
@pytest.mark.parametrize("kernel", ["K20", "K22"])
def test_plain_matches_jax(kernel, ps, G, splits):
    """One run of pages (JAX's sequential page walk) within 1e-6 of max
    |jax|; two and four within 2^-8."""
    arrs = _case(150 + G + ps, G, ps)
    for layer in range(2):
        before = _kernels.PLAIN_CALLS[kernel]
        got = _port(kernel, arrs, layer=layer, splits=splits)
        assert _kernels.PLAIN_CALLS[kernel] == before + 1
        assert got.dtype == torch.float32
        _close(got.numpy(), _jax(kernel, G, ps, layer), ONE_TOL if splits == 1 else SPLIT_TOL)


@pytest.mark.parametrize("ps", [16, 512])
def test_k22_rounds_per_whole_page(ps):
    """At one split K22's plain version is JAX's page walk to f32 noise; K13's
    blocks of min(256, ps) rows round p per half page at ps 512, which
    parted from JAX by about 1e-4 of max |out|."""
    arrs = _case(150 + 1 + ps, 1, ps)
    want = _jax("K22", 1, ps, 1)
    got = _port("K22", arrs, layer=1, splits=1).numpy()
    assert np.abs(got - want).max() <= ONE_TOL * np.abs(want).max()
    q, k, v, ks, vs, pt, pos = (torch.tensor(a) for a in arrs[:7])
    qs, acc, m, l = tatt._paged_online(q, k, v, ks, vs, pt, pos + 1, 1, tatt._paged_block(ps))
    half = (acc / torch.clamp_min(l, 1e-30)[..., None]).numpy()
    assert (np.abs(half - want).max() > 10 * ONE_TOL * np.abs(want).max()) == (ps > 256)


@pytest.mark.parametrize("splits", [1, 2, 3, 4, None])
@pytest.mark.parametrize("ps", [16, 512])
def test_empty_splits(ps, splits):
    """K22 at pos -1 gives zeros and K20 at pos 0 the fresh column alone (e_new
    = 1, times nvs, times nv), bit for bit, at every split; a slot whose rows
    all lie in the first run of pages (every later split empty) gives the
    one-split result bit for bit."""
    arrs = list(_case(7, 2, ps))
    MP = SHAPES[ps][0]
    first = tatt.split_spans(MP * ps, ps, splits or tatt.page_splits(
        torch.zeros(4, 2, 2, 16), torch.zeros(1, 1, 2, ps, 16), torch.zeros(4, MP), None))[0][1]
    arrs[6] = np.array([-1, 0, min(first, ps) - 1, MP * ps - 1], np.int32)
    k22 = _port("K22", arrs, layer=0, splits=splits)
    assert not k22[0].any() and torch.isfinite(k22).all()
    assert torch.equal(k22[2], _port("K22", arrs, layer=0, splits=1)[2])
    arrs[6] = np.array([0, 0, min(first, ps), MP * ps], np.int32)
    k20 = _port("K20", arrs, layer=0, splits=splits)
    nv, nvs = torch.tensor(arrs[8]), torch.tensor(arrs[10])
    fresh = nv[0].float() * nvs[0][:, None]
    assert torch.equal(k20[0], fresh[:, None, :].expand(-1, k20.shape[2], -1))
    assert torch.equal(k20[2], _port("K20", arrs, layer=0, splits=1)[2])


@pytest.mark.parametrize("splits", [1, 3, None])
@pytest.mark.parametrize("ps", [16, 512])
@pytest.mark.parametrize("kernel", ["K20", "K22"])
def test_rows_no_slot_attends_are_ignored(kernel, ps, splits):
    """Rows past each slot's last attended row (pos - 1 for K20, pos for K22),
    the pages past it, unused pages and page 0 may hold anything (int8 127,
    scale 1e9): the output does not change by one bit."""
    arrs = _case(11, 2, ps)
    base = _port(kernel, arrs, layer=1, splits=splits)
    k, v, ks, vs, pt, pos = arrs[1], arrs[2], arrs[3], arrs[4], arrs[5], arrs[6]
    live = np.zeros(k.shape[1:4], bool)  # (page, head, row) attended by some slot
    for b, p in enumerate(pos):
        for s in range(p + (kernel == "K22")):
            live[pt[b, s // ps], :, s % ps] = True
    for arr, val in ((k, 127), (v, 127), (ks, 1e9), (vs, 1e9)):
        arr[1][~live] = val
    assert torch.equal(base, _port(kernel, arrs, layer=1, splits=splits))


def test_split_rule():
    """K13's count capped at the page count MP, a function of the shapes
    alone: at the 7B table's shapes (pools of 512-row pages, MP 4) 1 / 4 / 4
    / 4; an explicit count passes through."""
    def rule(B, KVH, ps, MP, splits=None):
        q = torch.zeros(B, KVH, 1, 128)
        return tatt.page_splits(q, torch.zeros(1, 1, KVH, ps, 1), torch.zeros(B, MP), splits)

    assert [rule(8, 32, 512, 4), rule(8, 8, 512, 4), rule(1, 32, 512, 4)] == [1, 4, 4]
    for B in (1, 2, 4, 8, 32):
        for KVH in (1, 8, 32):
            for ps in (16, 64, 256, 512, 1024):
                for MP in (1, 2, 4, 8, 64):
                    k13 = tatt.decode_splits(B, KVH, tatt._paged_block(ps), MP * ps)
                    assert rule(B, KVH, ps, MP) == min(k13, MP)
    assert rule(1, 32, 512, 4, splits=7) == 7


def test_splits_argument():
    """Anything but a positive int is refused; None is the rule's count."""
    arrs = _case(3, 1, 16)
    for kernel in NAMES:
        n = tatt.page_splits(torch.zeros(4, 2, 1, 16), torch.zeros(1, 1, 2, 16, 16),
                             torch.zeros(4, 8), None)
        assert torch.equal(_port(kernel, arrs, layer=0), _port(kernel, arrs, layer=0, splits=n))
        for bad in (0, -1, 1.5):
            with pytest.raises(ValueError, match="splits"):
                _port(kernel, arrs, layer=0, splits=bad)


def test_ring_tile_and_shared_memory():
    """The ring tiles are K13's key blocks (min(256, ps) rows, halved until
    they divide the page); a block's shared memory at the 7B pools' page
    of 512 rows leaves an SM two blocks (115712 bytes each) with a ring of
    two tiles at every G, and a page too large for one block at G 8 is
    found."""
    assert [tatt._paged_block(ps) for ps in (16, 128, 512, 200, 96, 1, 768, 320)] == \
        [16, 128, 256, 200, 96, 1, 256, 64]
    for G in (1, 4, 8):
        assert tatt.page_cell_bytes(2, tatt._paged_block(512), 512, 128, G) <= 115712
    assert tatt.page_cell_bytes(2, tatt._paged_block(8192), 8192, 128, 8) > 232448

"""On-device sampling, with ``jax.random``'s threefry stream.

Port of tpu_llama/ops/sampling.py (``greedy``, ``sample``,
``sample_nosort``).  The JAX package has no Pallas kernel here, so this is
plain PyTorch on the logits' device.

A request's sampled tokens must equal the JAX engine's, so the random bits
are JAX's own: threefry2x32 keys as ``[..., 2]`` integer tensors (JAX's
``key_data``), ``key``, ``fold_in`` and ``uniform`` with the bit layout of
``jax_threefry_partitionable=True`` (JAX's default) and JAX's 32-bit seed
handling.  The 32-bit words live in int64 tensors under ``& 0xFFFFFFFF``
masks: PyTorch's uint32 has partial operator coverage on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as int64 [2] on the CPU:
    with JAX's default 32-bit ints a seed keeps its low 32 bits, and the
    high word is 0 (negative seeds wrap)."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64)


def keys_numpy(seeds) -> np.ndarray:
    """``key`` for many seeds at once, as an int64 [n, 2] host array."""
    out = np.zeros((len(seeds), 2), np.int64)
    out[:, 1] = [int(s) & _M32 for s in seeds]
    return out


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block (20 rounds) on 32-bit words held in int64,
    broadcasting key words against counter words.  Returns (y0, y1)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on key data [..., 2] and data broadcastable to
    keys[..., 0] (ints, wrapped to uint32 as JAX does): the threefry block
    of the key over the counter (0, data).  Returns [..., 2] int64."""
    keys = keys.long()
    d = torch.as_tensor(data, device=keys.device).long() & _M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element, [*keys.shape[:-1], *shape] int64:
    element i (row-major within ``shape``) is y0 ^ y1 of the threefry block
    over the counter (i >> 32, i & 0xFFFFFFFF), the partitionable layout."""
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k0 = keys[..., 0].long().reshape(*lead, 1)
    k1 = keys[..., 1].long().reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 for each key of [..., 2]: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled by
    (maxval - minval), plus minval, clamped below at minval.  Returns
    [*keys.shape[:-1], *shape] float32."""
    bits = random_bits(keys, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))  # rounded to f32, as JAX
    return torch.clamp_min(f * span + lo, lo)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[..., V] -> [...] argmax, ties to the lowest index."""
    return logits.argmax(dim=-1)


def _rows(v, B: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device).broadcast_to((B,))


def _softmax_scaled(logits, temperature):
    """softmax(logits / max(t, 1e-6)) in f32, as ``jax.nn.softmax``:
    exp(x - max) over its sum."""
    scaled = logits.float() / torch.clamp_min(temperature, 1e-6)[:, None]
    e = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _gumbel_u(keys: torch.Tensor, B: int, V: int) -> torch.Tensor:
    """The uniform draw of ``sample``: per-row keys [B, 2] draw (V,) each; a
    single key [2] draws (B, V)."""
    if keys.dim() == 2 and keys.shape[0] == B:
        return uniform(keys, (V,), minval=1e-20, maxval=1.0)
    return uniform(keys.reshape(2), (B, V), minval=1e-20, maxval=1.0)


def _gumbel_argmax(kept, keys, B: int, V: int) -> torch.Tensor:
    u = _gumbel_u(keys.to(kept.device), B, V)
    gumbel = -torch.log(-torch.log(u))
    return (torch.log(torch.clamp_min(kept, 1e-38)) + gumbel).argmax(dim=-1)


def sample(logits: torch.Tensor, keys: torch.Tensor, temperature=1.0, topp=1.0,
           topk=0) -> torch.Tensor:
    """Temperature / top-p / top-k sampling over a stable sort of the
    probabilities (sampling.py:30-81): [B, V] f32 -> [B] int64.
    temperature <= 0 is greedy for that row; topp outside (0, 1) and
    topk <= 0 switch their filter off.  ``keys``: [B, 2] per-row keys or
    one [2] key."""
    B, V = logits.shape
    dev = logits.device
    temperature = _rows(temperature, B, torch.float32, dev)
    topp = _rows(topp, B, torch.float32, dev)
    topk = _rows(topk, B, torch.int64, dev)
    probs = _softmax_scaled(logits, temperature)
    sorted_p, sort_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep = (csum - sorted_p) < topp[:, None]
    keep |= ~((topp > 0) & (topp < 1))[:, None]
    rank = torch.arange(V, device=dev)[None, :]
    keep &= (rank < topk[:, None]) | (topk <= 0)[:, None]
    choice = _gumbel_argmax(torch.where(keep, sorted_p, 0.0), keys, B, V)
    tok = sort_idx.gather(1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy(logits), tok)


def sample_nosort(logits: torch.Tensor, keys: torch.Tensor, temperature=1.0, topp=1.0,
                  topk=0, iters: int = 24) -> torch.Tensor:
    """``sample`` without the sort (sampling.py:84-159), the serving path:
    the top-p and top-k thresholds come from ``iters`` bisection steps on
    [0, pmax + 1] (a masked sum and a masked count each; a fixed loop, no
    data-dependent exit, so nothing waits for the device), then one masked
    gumbel-argmax.  Ties with the cutoff are all kept.  [B, V] -> [B]
    int64."""
    B, V = logits.shape
    dev = logits.device
    temperature = _rows(temperature, B, torch.float32, dev)
    topp = _rows(topp, B, torch.float32, dev)
    topk = _rows(topk, B, torch.int64, dev)
    probs = _softmax_scaled(logits, temperature)
    pmax = probs.amax(dim=-1)
    lo_p = torch.zeros((B,), dtype=torch.float32, device=dev)
    lo_k = torch.zeros_like(lo_p)
    hi_p = pmax + 1.0
    hi_k = hi_p.clone()
    for _ in range(iters):
        mid_p = 0.5 * (lo_p + hi_p)
        mid_k = 0.5 * (lo_k + hi_k)
        mass = torch.where(probs >= mid_p[:, None], probs, 0.0).sum(dim=-1)
        count = (probs >= mid_k[:, None]).sum(dim=-1)
        gt_p = mass > topp
        ge_k = count >= topk
        lo_p, hi_p = torch.where(gt_p, mid_p, lo_p), torch.where(gt_p, hi_p, mid_p)
        lo_k, hi_k = torch.where(ge_k, mid_k, lo_k), torch.where(ge_k, hi_k, mid_k)
    thr = torch.maximum(torch.where((topp > 0) & (topp < 1), lo_p, 0.0),
                        torch.where(topk > 0, lo_k, 0.0))
    tok = _gumbel_argmax(torch.where(probs >= thr[:, None], probs, 0.0), keys, B, V)
    return torch.where(temperature <= 0.0, greedy(logits), tok)

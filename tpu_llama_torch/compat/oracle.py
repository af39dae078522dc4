"""Float64-accumulating oracle forward pass -- the bit-exactness anchor.

A copy of ``tpu_llama.compat.oracle`` on the port's ``RawWeights`` and
``ModelConfig`` (numpy only, no device work).

JavaScript numbers are IEEE float64; the reference's arrays are Float32Array.
So every arithmetic step in llama2.ts happens in f64 and rounds to f32 only
when stored.  This oracle reproduces that numeric model with numpy:
f64 compute, f32 stores at exactly the reference's store points.

One documented divergence: numpy's f64 dot products use pairwise/blocked
summation while JS sums strictly sequentially.  The difference is O(1 ulp) in
f64 and is absorbed by the f32 rounding on store in all but astronomically
rare boundary cases; argmax/sampling decisions -- the actual compatibility
contract ("same outputs given parameters and seed", reference README:9) -- are
unaffected.  llama2.c itself accumulates in f32 and still matches the TS
reference token-for-token, so the contract tolerates far more drift than this.

Structure mirrors llama2.ts:205-303 (`transformer`) step for step; citations
inline.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.io.checkpoint import RawWeights

_F32 = np.float32
_F64 = np.float64


@dataclasses.dataclass
class OracleState:
    """fp32 activation workspace + dense fp32 KV cache (llama2.ts:131-163)."""

    x: np.ndarray
    key_cache: np.ndarray  # (L, seq_len, kv_dim)
    value_cache: np.ndarray  # (L, seq_len, kv_dim)
    logits: np.ndarray  # (vocab,)

    @classmethod
    def create(cls, c: ModelConfig) -> "OracleState":
        return cls(
            x=np.zeros(c.dim, _F32),
            key_cache=np.zeros((c.n_layers, c.seq_len, c.kv_dim), _F32),
            value_cache=np.zeros((c.n_layers, c.seq_len, c.kv_dim), _F32),
            logits=np.zeros(c.vocab_size, _F32),
        )


def _rmsnorm(x: np.ndarray, weight: np.ndarray) -> np.ndarray:
    # llama2.ts:172-179 -- f64 sum of squares, eps=1e-5 INSIDE the sqrt,
    # one f32 store per element.
    xd = x.astype(_F64)
    ss = float(xd @ xd) / x.shape[0]
    ss = 1.0 / math.sqrt(1e-5 + ss)
    return (weight.astype(_F64) * (ss * xd)).astype(_F32)


def _softmax_inplace_f32(x: np.ndarray) -> np.ndarray:
    # llama2.ts:181-194 -- exp stored to f32, f64 sum of the stored values,
    # division stored to f32.
    m = np.max(x)
    e = np.exp(x.astype(_F64) - _F64(m)).astype(_F32)
    s = float(np.sum(e.astype(_F64)))
    return (e.astype(_F64) / s).astype(_F32)


def _matmul(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    # llama2.ts:196-203 -- W(d, n) @ x(n), f64 accumulation, f32 store.
    return (w.astype(_F64) @ x.astype(_F64)).astype(_F32)


def oracle_forward(
    token: int, pos: int, c: ModelConfig, s: OracleState, w: RawWeights
) -> np.ndarray:
    """One single-token forward step; returns and stores fp32 logits."""
    hd = c.head_dim
    kvd = c.kv_dim
    gs = c.group_size  # queries per kv head (1:1 in v0 checkpoints)

    # embed (llama2.ts:211)
    x = w.token_embedding[token].copy()

    fcr = w.freq_cis_real[pos].astype(_F64)  # (hd/2,)
    fci = w.freq_cis_imag[pos].astype(_F64)

    for layer in range(c.n_layers):
        xb = _rmsnorm(x, w.rms_att[layer])

        # qkv matmuls (llama2.ts:219-221)
        q = _matmul(w.wq[layer], xb)  # (dim,)
        k = _matmul(w.wk[layer], xb)  # (kv_dim,)
        v = _matmul(w.wv[layer], xb)  # (kv_dim,)

        # RoPE: rotate interleaved (even, odd) pairs with the precomputed
        # tables; freq index is (i % head_size)/2 (llama2.ts:224-235).
        def rope(vec: np.ndarray) -> np.ndarray:
            pairs = vec.astype(_F64).reshape(-1, hd // 2, 2)
            r0 = pairs[..., 0] * fcr - pairs[..., 1] * fci
            r1 = pairs[..., 0] * fci + pairs[..., 1] * fcr
            return np.stack([r0, r1], axis=-1).reshape(vec.shape).astype(_F32)

        q = rope(q)
        k = rope(k)

        # KV cache write at (layer, pos) (llama2.ts:238-240)
        s.key_cache[layer, pos] = k
        s.value_cache[layer, pos] = v

        # attention (llama2.ts:243-267); GQA generalization: query head h
        # attends to kv head h // gs (degenerates to h when gs == 1).
        xb = np.zeros(c.dim, _F32)
        inv_sqrt_hd = 1.0 / math.sqrt(hd)
        for h in range(c.n_heads):
            qh = q[h * hd : (h + 1) * hd].astype(_F64)
            kvh = h // gs
            keys = s.key_cache[layer, : pos + 1, kvh * hd : (kvh + 1) * hd]
            # scores: f64 dot / sqrt(hd), f32 store (llama2.ts:249-254)
            att = ((keys.astype(_F64) @ qh) * inv_sqrt_hd).astype(_F32)
            att = _softmax_inplace_f32(att)
            # weighted value sum accumulates INTO the f32 xb buffer -- one
            # f32 rounding per timestep, sequential in t (llama2.ts:260-265).
            acc = np.zeros(hd, _F32)
            vals = s.value_cache[layer, : pos + 1, kvh * hd : (kvh + 1) * hd]
            for t in range(pos + 1):
                acc = (
                    acc.astype(_F64) + _F64(att[t]) * vals[t].astype(_F64)
                ).astype(_F32)
            xb[h * hd : (h + 1) * hd] = acc

        # attention output + residual (llama2.ts:270-273)
        xb2 = _matmul(w.wo[layer], xb)
        x = (x.astype(_F64) + xb2.astype(_F64)).astype(_F32)

        # FFN: rmsnorm, w1/w3, SiLU, hadamard, w2, residual (llama2.ts:276-295)
        xb = _rmsnorm(x, w.rms_ffn[layer])
        hb = _matmul(w.w1[layer], xb)
        hb2 = _matmul(w.w3[layer], xb)
        hb64 = hb.astype(_F64)
        hb = (hb64 * (1.0 / (1.0 + np.exp(-hb64)))).astype(_F32)  # f32 store
        hb = (hb.astype(_F64) * hb2.astype(_F64)).astype(_F32)  # f32 store
        xb = _matmul(w.w2[layer], hb)
        x = (x.astype(_F64) + xb.astype(_F64)).astype(_F32)

    # final rmsnorm + classifier (llama2.ts:299-302)
    x = _rmsnorm(x, w.rms_final)
    s.logits = _matmul(w.wcls, x)
    s.x = x
    return s.logits

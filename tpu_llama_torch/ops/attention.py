"""INT8 KV quantization, causal prefill attention (K6) and the slot scatter
that admits a prefilled block into the cache (K7).

Port of tpu_llama/ops/attention.py: ``quantize_kv`` (:2551),
``flash_prefill_attention`` (:1654) and ``kv_cache_scatter_slots`` (:1212),
for INT8 caches; the fp-cache variants come with their ROADMAP slice.
"""

from __future__ import annotations

import math

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.quant import _absmax_quant

_NEG_INF = -1e30


def quantize_kv(x: torch.Tensor):
    """Per-(..., row) symmetric INT8 over the last (hd) axis:
    x [..., hd] -> (int8 [..., hd], f32 scales [...])."""
    return _absmax_quant(x.float(), dim=-1)


def _check_prefill(q, k_cache, v_cache, start_pos, k_scale, v_scale):
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
        raise NotImplementedError("flash_prefill_attention: fp caches come with the "
                                  "fp-cache slice (ROADMAP queue 1 item 9)")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("want q [B, T, NH, hd] and k_cache [B, KVH, S, hd]")
    B, T, NH, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, KVH, S, hd) or v_cache.shape != k_cache.shape
            or k_scale.shape != (B, KVH, S) or v_scale.shape != k_scale.shape
            or start_pos.shape != (B,) or NH % KVH):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}, ks {tuple(k_scale.shape)}, "
                         f"vs {tuple(v_scale.shape)}, start {tuple(start_pos.shape)}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("K/V scales must be float32")


def flash_prefill_attention_plain(q, k_cache, v_cache, start_pos, k_scale, v_scale,
                                  out_dtype=None):
    """Plain version of K6: f32 attention on the dequantized cache, as
    ``_attention_prefill`` computes it (llama.py:582-603)."""
    B, T, NH, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    G = NH // KVH
    kf = k_cache.float() * k_scale[..., None]
    vf = v_cache.float() * v_scale[..., None]
    qg = q.reshape(B, T, KVH, G, hd).float()
    scores = torch.einsum("btkgh,bksh->bkgts", qg, kf) / math.sqrt(hd)
    q_pos = start_pos.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = torch.arange(S, device=q.device)[None, None, None, None, :] <= \
        q_pos[:, None, None, :, None]
    att = torch.softmax(scores.masked_fill(~mask, _NEG_INF), dim=-1)
    out = torch.einsum("bkgts,bksh->btkgh", att, vf)
    return out.reshape(B, T, NH * hd).to(out_dtype or torch.float32)


def flash_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            start_pos: torch.Tensor, k_scale: torch.Tensor,
                            v_scale: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Causal prefill attention: q [B, T, NH, hd] (raw queries), INT8 K/V
    [B, KVH, S, hd] already holding this chunk, f32 scales [B, KVH, S],
    start_pos [B] (absolute position of q[:, 0]).  Key s attends iff
    s <= start_pos[b] + t.  Returns [B, T, NH * hd] in ``out_dtype``
    (default f32).  K6 on CUDA tensors, the plain version on CPU ones."""
    _check_prefill(q, k_cache, v_cache, start_pos, k_scale, v_scale)
    if _kernels.on_cpu("K6", q, k_cache, v_cache, start_pos, k_scale, v_scale):
        return flash_prefill_attention_plain(q, k_cache, v_cache, start_pos, k_scale,
                                             v_scale, out_dtype)
    out_dtype = out_dtype or torch.float32
    B, T, NH, hd = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    if hd > 128:
        raise NotImplementedError(f"K6 takes head_dim <= 128, got {hd}")
    qc = q.contiguous()
    kc, vc = k_cache.contiguous(), v_cache.contiguous()
    ks, vs = k_scale.contiguous(), v_scale.contiguous()
    st = start_pos.to(torch.int32).contiguous()
    out = torch.empty((B, T, NH * hd), dtype=out_dtype, device=q.device)
    sqrt_hd = float(torch.tensor(hd, dtype=torch.float32).sqrt())  # jnp.sqrt(f32(hd))
    _kernels.launch("K6", qc.data_ptr(), _kernels.dtype_code(qc.dtype), kc.data_ptr(),
                    vc.data_ptr(), ks.data_ptr(), vs.data_ptr(), st.data_ptr(),
                    out.data_ptr(), _kernels.dtype_code(out_dtype), B, T, NH, KVH, S, hd,
                    sqrt_hd, _kernels.stream(qc))
    return out


def _check_scatter(small_k, small_v, slots, ck, cv, small_ks, small_vs, cks, cvs):
    if small_k.dim() != 5 or ck.dim() != 5:
        raise ValueError("want small_k [L, n, KVH, T, hd] and ck [L, B, KVH, S, hd]")
    L, n, KVH, T, hd = small_k.shape
    B, S = ck.shape[1], ck.shape[3]
    if (small_v.shape != small_k.shape or ck.shape != (L, B, KVH, S, hd)
            or cv.shape != ck.shape or small_ks.shape != (L, n, KVH, T)
            or small_vs.shape != small_ks.shape or cks.shape != (L, B, KVH, S)
            or cvs.shape != cks.shape):
        raise ValueError("kv_cache_scatter_slots: shape mismatch")
    if any(t.dtype != torch.int8 for t in (small_k, small_v, ck, cv)) or any(
            t.dtype != torch.float32 for t in (small_ks, small_vs, cks, cvs)):
        raise TypeError("kv_cache_scatter_slots takes int8 K/V and float32 scales")
    if T > S:
        raise ValueError(f"block of {T} rows does not fit a cache of {S}")
    idx = [int(s) for s in (slots.tolist() if isinstance(slots, torch.Tensor) else slots)]
    if len(idx) != n:
        raise ValueError(f"{len(idx)} slots for a block of {n}")
    if any(not 0 <= s < B for s in idx) or len(set(idx)) != len(idx):
        raise ValueError(f"slots {idx} must be distinct and in [0, {B})")
    return idx


def kv_cache_scatter_slots_plain(small_k, small_v, slots, ck, cv, small_ks, small_vs,
                                 cks, cvs):
    """Plain version of K7: one slot at a time, in place."""
    T = small_k.shape[3]
    for i, s in enumerate(slots):
        ck[:, s, :, :T].copy_(small_k[:, i])
        cv[:, s, :, :T].copy_(small_v[:, i])
        cks[:, s, :, :T].copy_(small_ks[:, i])
        cvs[:, s, :, :T].copy_(small_vs[:, i])
    return ck, cv, cks, cvs


def kv_cache_scatter_slots(small_k, small_v, slots, ck, cv, small_ks, small_vs, cks, cvs):
    """Write rows [0, T) of each chosen slot of the INT8 cache IN PLACE:
    ``ck[:, slots[i], :, :T] = small_k[:, i]`` for K, V and both scale
    arrays.  small_k [L, n, KVH, T, hd], slots: n host ints (distinct,
    < B; a tensor is read back to the host for the check, which waits for
    its stream), ck [L, B, KVH, S, hd], scales [L, ., KVH, .].  Returns the
    (updated) cache arrays.  K7 on CUDA tensors, the plain version on CPU
    ones."""
    idx = _check_scatter(small_k, small_v, slots, ck, cv, small_ks, small_vs, cks, cvs)
    arrays = (small_k, small_v, small_ks, small_vs, ck, cv, cks, cvs)
    if _kernels.on_cpu("K7", *arrays):
        return kv_cache_scatter_slots_plain(small_k, small_v, idx, ck, cv, small_ks,
                                            small_vs, cks, cvs)
    if not all(t.is_contiguous() for t in (ck, cv, cks, cvs)):
        raise ValueError("K7 writes the cache in place: it must be contiguous")
    L, n, KVH, T, hd = small_k.shape
    B, S = ck.shape[1], ck.shape[3]
    sk, sv = small_k.contiguous(), small_v.contiguous()
    sks, svs = small_ks.contiguous(), small_vs.contiguous()
    sl = torch.tensor(idx, dtype=torch.int32, device=ck.device)
    vec = hd % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (sk, sv, ck, cv))
    _kernels.launch("K7", sk.data_ptr(), sv.data_ptr(), sks.data_ptr(), svs.data_ptr(),
                    sl.data_ptr(), ck.data_ptr(), cv.data_ptr(), cks.data_ptr(),
                    cvs.data_ptr(), L, n, KVH, T, hd, B, S, int(vec), _kernels.stream(ck))
    return ck, cv, cks, cvs

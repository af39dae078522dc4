"""mega2: one launch per decode layer with the next layer's attention
trailing its linear work (K12).

Port of tpu_llama/ops/fused_step2.py:537 ``fused_step2_layer``.  Launch
``l`` runs layer ``l``'s linear phases (K11's, with h2 staged in bf16,
:217-224), then post-processes layer ``l + 1``'s q/k/v (q roped, times
1/sqrt(hd), rounded to bf16; k roped and quantized per head; v quantized
per head, :245-296), attends over the cache rows below each slot's position
(K9's online softmax over 128-row key blocks), merges the fresh column and
quantizes the attention output (:714-737) -- all inside the one launch on
the card.  The TPU's DMA descriptor chain (``decode_dma_descs``,
``step2_plan``, :451-515) and its signed rope tables (``rope_tables``,
:518) are not carried: a CUDA block computes its cache offsets from ``pos``
and rotates interleaved pairs directly.
"""

from __future__ import annotations

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.attention import (
    _dma_block,
    _fresh_tail_merge,
    check_cache,
    decode_online_softmax,
    launch_chunk,
    quantize_kv,
)
from tpu_llama_torch.ops.fused_layer import (
    MAX_ROWS,
    check_layer,
    launch_args,
    layer_views,
    linear_phases_plain,
)
from tpu_llama_torch.ops.quant import (ChannelQuantTensor, quantize_activations_plain, rope_f32,
                                       sqrt_f32)


def inv_sqrt_hd(hd: int) -> float:
    """f32(1 / sqrt(f32(hd))), as ``1.0 / jnp.sqrt(jnp.float32(hd))`` (:152)."""
    return float(torch.tensor(1.0) / sqrt_f32(hd))


def _outputs(B, D, KVH, hd, dev, out):
    """(attq_next, satt_next, kq, ks, vq, vs): new buffers, with ``out``'s
    (kq, ks, vq, vs) in their places when given."""
    if out is None:
        out = (torch.empty((B, KVH, hd), dtype=torch.int8, device=dev),
               torch.empty((B, KVH), dtype=torch.float32, device=dev),
               torch.empty((B, KVH, hd), dtype=torch.int8, device=dev),
               torch.empty((B, KVH), dtype=torch.float32, device=dev))
    kq, ks, vq, vs = out
    if (kq.shape != (B, KVH, hd) or vq.shape != kq.shape or ks.shape != (B, KVH)
            or vs.shape != ks.shape or kq.dtype != torch.int8 or vq.dtype != torch.int8
            or ks.dtype != torch.float32 or vs.dtype != torch.float32
            or not all(t.is_contiguous() for t in out)):
        raise ValueError(f"out: want contiguous int8 [{B}, {KVH}, {hd}] rows and f32 "
                         f"[{B}, {KVH}] scales")
    return (torch.empty((B, D), dtype=torch.int8, device=dev),
            torch.empty((B,), dtype=torch.float32, device=dev), kq, ks, vq, vs)


def step2_inputs(B, D, QO, L, Bc, KVH, hd, n_heads, n_layers, cos, sin) -> None:
    """Check that a cache [L, Bc, KVH, S, hd] and the rope rows cos, sin
    fit a K12 (or K26) call of B rows, width D and qkv width QO."""
    if (KVH * hd != (QO - D) // 2 or n_heads * hd != D or n_heads % KVH or Bc != B
            or L != n_layers):
        raise ValueError(f"cache of {L} layers, {Bc} slots, {KVH} kv heads of {hd} does not "
                         f"fit n_heads {n_heads}, D {D}, QO {QO}, batch {B}, {n_layers} layers")
    if cos.shape != (B, hd // 2) or sin.shape != cos.shape or cos.dtype != torch.float32 \
            or sin.dtype != torch.float32:
        raise ValueError(f"want cos and sin f32 [{B}, {hd // 2}]")


def fused_step2_layer_plain(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin,
                            wo, w13, w2, wqkv, rms_ffn, rms_att, layer: int, n_layers: int,
                            n_heads: int, out=None):
    """Plain version of K12 (its arguments and results are
    :func:`fused_step2_layer`'s)."""
    B, D = x.shape
    _, _, KVH, S, hd = k_cache.shape
    G = n_heads // KVH
    views = layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    last = layer + 1 >= n_layers
    x_next, qkv = linear_phases_plain(x, attq, satt, *views, last=last, bf16_h2=True)
    attq_n, satt_n, kq, ks, vq, vs = _outputs(B, D, KVH, hd, x.device, out)
    if last:
        return x_next, attq_n, satt_n, kq, ks, vq, vs
    KVD = KVH * hd
    q = rope_f32(qkv[:, :D].reshape(B, n_heads, hd), cos, sin) * inv_sqrt_hd(hd)
    qb = q.to(torch.bfloat16).float().reshape(B, KVH, G, hd)
    kq_, ks_ = quantize_kv(rope_f32(qkv[:, D:D + KVD].reshape(B, KVH, hd), cos, sin))
    vq_, vs_ = quantize_kv(qkv[:, D + KVD:].reshape(B, KVH, hd))
    acc, m, l = decode_online_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos, layer + 1,
                                      _dma_block(S, None))
    att = _fresh_tail_merge(acc, m, l, qb, kq_, vq_, ks_, vs_).reshape(B, D)
    q_att, s_att = quantize_activations_plain(att)
    for dst, src in zip((attq_n, satt_n, kq, ks, vq, vs), (q_att, s_att, kq_, ks_, vq_, vs_)):
        dst.copy_(src)
    return x_next, attq_n, satt_n, kq, ks, vq, vs


def fused_step2_layer(x: torch.Tensor, attq: torch.Tensor, satt: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, pos: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor, wo: ChannelQuantTensor, w13: ChannelQuantTensor,
                      w2: ChannelQuantTensor, wqkv: ChannelQuantTensor, rms_ffn: torch.Tensor,
                      rms_att: torch.Tensor, layer: int, n_layers: int, n_heads: int, out=None):
    """Layer ``layer``'s linear work and layer ``layer + 1``'s attention.
    x, attq, satt, the weights and the rms rows as
    :func:`~tpu_llama_torch.ops.fused_layer.fused_layer_linear`; the INT8
    cache [L, B, KVH, S, hd] with f32 scales [L, B, KVH, S], read only; pos
    [B] (read on the device); cos, sin f32 [B, hd/2] at each slot's
    position.  Returns the JAX function's tuple (x_next f32 [B, D],
    attq_next int8 [B, D], satt_next f32 [B], kq int8 [B, KVH, hd], ks f32
    [B, KVH], vq, vs): the next launch's attention input and layer
    ``layer + 1``'s fresh K/V rows for the step's flush.  ``out=(kq, ks, vq,
    vs)`` writes the rows into given contiguous tensors (e.g. one layer of
    the step's flush buffers).  At the last layer only x_next is computed:
    the other outputs come back untouched.  B <= 32 on the card.  K12 on
    CUDA tensors (one cooperative launch), the plain version on CPU ones."""
    layer = int(layer)
    B, D, H, QO = check_layer(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att, layer,
                              n_layers)
    L, Bc, KVH, S, hd = check_cache("fused_step2_layer", k_cache, v_cache, k_scale, v_scale,
                                    pos)
    step2_inputs(B, D, QO, L, Bc, KVH, hd, n_heads, n_layers, cos, sin)
    G = n_heads // KVH
    tensors = (x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin, wo.q, w13.q,
               w2.q, wqkv.q, rms_ffn, rms_att) + (tuple(out) if out is not None else ())
    if _kernels.on_cpu("K12", *tensors):
        return fused_step2_layer_plain(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos,
                                       cos, sin, wo, w13, w2, wqkv, rms_ffn, rms_att, layer,
                                       n_layers, n_heads, out)
    if B > MAX_ROWS or G > 8 or hd > 128:
        raise NotImplementedError(f"K12 takes up to {MAX_ROWS} rows, 8 query heads per kv "
                                  f"head and head_dim <= 128, got B={B}, G={G}, hd={hd}")
    ts = _dma_block(S, None)
    ch = launch_chunk("K12", k_cache, v_cache, hd, k_scale, v_scale)
    views = layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    x, attq, satt = x.contiguous(), attq.contiguous(), satt.contiguous()
    cs, sn = cos.contiguous(), sin.contiguous()
    p32 = pos.to(torch.int32).contiguous()
    dev = x.device
    x_next = torch.empty((B, D), dtype=torch.float32, device=dev)
    qkv = torch.empty((B, QO), dtype=torch.float32, device=dev)
    att = torch.empty((B, D), dtype=torch.float32, device=dev)
    outs = _outputs(B, D, KVH, hd, dev, out)
    last = layer + 1 >= n_layers
    args, keep = launch_args(x, attq, satt, views, x_next, qkv, B, D, H, QO, last)
    if B:
        _kernels.launch("K12", *args, k_cache.data_ptr(), v_cache.data_ptr(),
                        k_scale.data_ptr(), v_scale.data_ptr(), p32.data_ptr(), cs.data_ptr(),
                        sn.data_ptr(), att.data_ptr(), *(t.data_ptr() for t in outs), KVH, G,
                        hd, S, min(layer + 1, L - 1), ts, inv_sqrt_hd(hd), ch,
                        _kernels.stream(x))
    del keep, qkv, att
    return (x_next, *outs)

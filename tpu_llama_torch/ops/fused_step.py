"""mega: one launch per decode layer with the layer's attention leading its
linear work (K27).

Port of tpu_llama/ops/fused_step.py:313 ``fused_step_layer``.  One launch
runs layer ``l``'s attention over the cache rows strictly below each slot's
position with the step's fresh row merged in the cell, quantizes the
attention output over the whole D row, then runs K11's phases A-D (the
layer's linear work and layer ``l + 1``'s qkv) -- K12's two halves in the
other order, on csrc/fused_step2.cuh's streaming body.  Its arithmetic is
K9's split cell (q divided by sqrt(hd), bf16 q and p * vs in the cache
dots, the fresh row scored with the unrounded q, acc / max(l, 1e-30)) on
``splits`` spans of the key rows (None: ``fused_splits``, K12's rule), K2's
row quant and K11's phases, so the plain version is that composition and
on the card K27 equals K9 at the same splits, K2 and K11 launched in turn.
At one split the cell is the sequential block walk; at more, p rounds
against each split's running max (K9's accepted departure: within 2^-8 of
max |out| of the JAX function).  The key block is the port's own: K9's
default (128 rows, halved until it divides S); the TPU kernel's comes from
its VMEM plan (``_pick_step_tiling``, :298), which is not carried.  RoPE
and the fresh rows' quant stay between launches (llama.py:1040-1047).
"""

from __future__ import annotations

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.attention import (_check_decode, _check_splits, _dma_block,
                                           flash_decode_attention_dma_plain, launch_chunk,
                                           split_workspace)
from tpu_llama_torch.ops.fused_layer import (MAX_ROWS, check_stack, launch_args, layer_views,
                                             linear_phases_plain)
from tpu_llama_torch.ops.fused_step2 import fused_splits, step2_scratch
from tpu_llama_torch.ops.quant import ChannelQuantTensor, quantize_activations_plain, sqrt_f32


def step_splits(B: int, KVH: int, S: int, splits: int | None) -> int:
    """The key-row splits of K27's cells: ``splits``, or None ->
    ``fused_splits`` at K9's key block (a function of the shapes alone)."""
    return fused_splits(B, KVH, _dma_block(S, None), S) if splits is None else splits


def fused_step_layer_plain(x, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale,
                           v_scale, pos, wo, w13, w2, wqkv, rms_ffn, rms_att, layer: int,
                           n_layers: int, qkv_out=None, att_out=None, splits=None):
    """Plain version of K27 (its arguments and results are
    :func:`fused_step_layer`'s): K9's plain version at the same ``splits``
    (None: ``step_splits``), K2's, then K11's phases."""
    B, D = x.shape
    _, _, KVH, S, _ = k_cache.shape
    att = flash_decode_attention_dma_plain(q, k_cache, v_cache, pos, new_k, new_v, k_scale,
                                           v_scale, new_ks, new_vs, layer=layer,
                                           splits=step_splits(B, KVH, S, splits))
    attq, satt = quantize_activations_plain(att.reshape(B, D))
    if att_out is not None:
        att_out[0].copy_(attq)
        att_out[1].copy_(satt)
    views = layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    x_next, qkv = linear_phases_plain(x, attq, satt, *views, last=layer + 1 >= n_layers)
    if qkv_out is None:
        qkv_out = torch.empty((B, wqkv.out_features), dtype=torch.float32, device=x.device)
    if qkv is not None:
        qkv_out.copy_(qkv)
    return x_next, qkv_out


def _check_att_out(att_out, B: int, D: int):
    if att_out is None:
        return
    if len(att_out) != 2:
        raise ValueError("want att_out=(attq, satt)")
    attq, satt = att_out
    if (attq.shape != (B, D) or attq.dtype != torch.int8 or satt.shape != (B,)
            or satt.dtype != torch.float32 or not attq.is_contiguous()
            or not satt.is_contiguous()):
        raise ValueError(f"att_out: want contiguous int8 [{B}, {D}] and f32 [{B}]")


def fused_step_layer(x: torch.Tensor, q: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, new_ks: torch.Tensor, new_vs: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, pos: torch.Tensor, wo: ChannelQuantTensor,
                     w13: ChannelQuantTensor, w2: ChannelQuantTensor, wqkv: ChannelQuantTensor,
                     rms_ffn: torch.Tensor, rms_att: torch.Tensor, layer: int, n_layers: int,
                     qkv_out: torch.Tensor | None = None, att_out=None,
                     splits: int | None = None):
    """All of decode layer ``layer``: x f32 [B, D] the residual entering
    it; q [B, KVH, G, hd] its roped, unscaled queries; new_k / new_v int8
    [B, KVH, hd] with f32 scales new_ks / new_vs [B, KVH] its fresh rows;
    the INT8 cache [L, B, KVH, S, hd] with f32 scales [L, B, KVH, S], read
    only (cache row s attends iff s < pos[b]); pos [B]; the stacked weights
    and rms rows as :func:`~tpu_llama_torch.ops.fused_layer.fused_layer_linear`.
    Returns (x_next f32 [B, D], qkv_next f32 [B, D + 2 KVD]); at the last
    layer qkv_next is not computed (``qkv_out``, or a new buffer, comes back
    untouched).  ``att_out=(attq int8 [B, D], satt f32 [B])`` receives the
    quantized attention output the linear phases ran on.  ``splits``: the
    key-row spans of the cells (None: ``fused_splits``, as K12's; at more
    than one, within 2^-8 of max |out| of the JAX function, as K9).  B <= 32
    on the card.  K27 on CUDA tensors (one cooperative launch), the plain
    version on CPU ones."""
    layer = int(layer)
    splits = _check_splits("fused_step_layer", splits)
    B, D, H, QO = check_stack(x, wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    _check_decode("fused_step_layer", q, k_cache, v_cache, pos, new_k, new_v, k_scale, v_scale,
                  new_ks, new_vs, layer)
    L, Bc, KVH, S, hd = k_cache.shape
    if k_cache.dtype != torch.int8 or Bc != B or L != n_layers or q.shape[2] * KVH * hd != D \
            or QO != D + 2 * KVH * hd:
        raise ValueError(f"fused_step_layer: an INT8 cache {tuple(k_cache.shape)} and q "
                         f"{tuple(q.shape)} that fit D {D}, QO {QO}, batch {B}, {n_layers} "
                         f"layers")
    if qkv_out is not None and (qkv_out.shape != (B, QO) or qkv_out.dtype != torch.float32
                                or not qkv_out.is_contiguous()):
        raise ValueError(f"want qkv_out contiguous f32 [{B}, {QO}]")
    _check_att_out(att_out, B, D)
    tensors = (x, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache, k_scale, v_scale, pos,
               wo.q, w13.q, w2.q, wqkv.q, rms_ffn, rms_att) + (
        () if qkv_out is None else (qkv_out,)) + (() if att_out is None else tuple(att_out))
    if _kernels.on_cpu("K27", *tensors):
        return fused_step_layer_plain(x, q, new_k, new_v, new_ks, new_vs, k_cache, v_cache,
                                      k_scale, v_scale, pos, wo, w13, w2, wqkv, rms_ffn,
                                      rms_att, layer, n_layers, qkv_out, att_out, splits)
    G = q.shape[2]
    if B > MAX_ROWS or G > 8 or hd > 128:
        raise NotImplementedError(f"K27 takes up to {MAX_ROWS} rows, 8 query heads per kv "
                                  f"head and head_dim <= 128, got B={B}, G={G}, hd={hd}")
    ts = _dma_block(S, None)
    n = step_splits(B, KVH, S, splits)
    ch = launch_chunk("K27", k_cache, v_cache, hd, k_scale, v_scale)
    dev = x.device
    st = _kernels.stream(x)
    x = x.contiguous()
    qc = q.float().contiguous()
    nk, nv, nks, nvs = (t.contiguous() for t in (new_k, new_v, new_ks, new_vs))
    p32 = pos.to(torch.int32).contiguous()
    attq, satt = att_out if att_out is not None else (
        torch.empty((B, D), dtype=torch.int8, device=dev),
        torch.empty((B,), dtype=torch.float32, device=dev))
    x_next = torch.empty((B, D), dtype=torch.float32, device=dev)
    qkv = qkv_out if qkv_out is not None else torch.empty((B, QO), dtype=torch.float32,
                                                          device=dev)
    views = layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    args, keep = launch_args(x, attq, satt, views, x_next, qkv, B, D, H, QO,
                             layer + 1 >= n_layers, st)
    # tl_fused_step_layer takes the fused-layer arguments without attq and satt
    lin = [args[0]] + args[3:]
    att = step2_scratch(dev, st, B, D, H, QO)["att"]
    cws, ctk = split_workspace(B, KVH, G, hd, n, dev, st)
    if B:
        _kernels.launch("K27", qc.data_ptr(), nk.data_ptr(), nv.data_ptr(), nks.data_ptr(),
                        nvs.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                        k_scale.data_ptr(), v_scale.data_ptr(), p32.data_ptr(), att.data_ptr(),
                        attq.data_ptr(), satt.data_ptr(),
                        None if cws is None else cws.data_ptr(),
                        None if ctk is None else ctk.data_ptr(), KVH, G, hd, S, layer, ts, n,
                        float(sqrt_f32(hd)), ch, *lin, st)
    del keep
    return x_next, qkv

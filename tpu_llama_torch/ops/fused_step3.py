"""mega3: one launch per pair of decode layers (K26).

Port of tpu_llama/ops/fused_step3.py:475 ``fused_step3_pair``.  Launch
``l0`` (even) runs layer ``l0``'s and ``l0 + 1``'s linear phases, layer
``l0 + 1``'s attention merged at a seam inside the launch, and layer
``l0 + 2``'s attention: two of K12's layers (:mod:`.fused_step2`) with a
grid barrier between them, so the result is two chained K12 launches', bit
for bit on the card, and the plain version is two calls of
``fused_step2_layer_plain``.  The last pair (``l0 + 2 == L``) stops after
layer ``l0 + 1``'s phase C, as K12's last layer does.  The TPU kernel's
VMEM plan (``step3_plan``), its one DMA descriptor walk across both halves
and its rope tables are not carried.
"""

from __future__ import annotations

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.attention import _check_splits, _dma_block, check_cache, launch_chunk
from tpu_llama_torch.ops.fused_layer import MAX_ROWS, check_layer
from tpu_llama_torch.ops.fused_step2 import (_outputs, _stacked_ptrs, fused_splits,
                                             fused_step2_layer_plain, step2_args, step2_inputs,
                                             step2_scratch)
from tpu_llama_torch.ops.quant import ChannelQuantTensor


def fused_step3_pair_plain(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin,
                           wo, w13, w2, wqkv, rms_ffn, rms_att, layer: int, n_layers: int,
                           n_heads: int, out=None, splits=None):
    """Plain version of K26: K12's plain version for layer ``layer``, then
    for ``layer + 1`` on its outputs, both at ``splits`` (the arguments and
    results of :func:`fused_step3_pair`)."""
    out1, out2 = (None, None) if out is None else out
    x1, attq1, satt1, *rows1 = fused_step2_layer_plain(
        x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin, wo, w13, w2, wqkv,
        rms_ffn, rms_att, layer, n_layers, n_heads, out=out1, splits=splits)
    x2, attq2, satt2, *rows2 = fused_step2_layer_plain(
        x1, attq1, satt1, k_cache, v_cache, k_scale, v_scale, pos, cos, sin, wo, w13, w2, wqkv,
        rms_ffn, rms_att, layer + 1, n_layers, n_heads, out=out2, splits=splits)
    return x2, attq2, satt2, tuple(rows1), tuple(rows2)


def fused_step3_pair(x: torch.Tensor, attq: torch.Tensor, satt: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor, pos: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, wo: ChannelQuantTensor, w13: ChannelQuantTensor,
                     w2: ChannelQuantTensor, wqkv: ChannelQuantTensor, rms_ffn: torch.Tensor,
                     rms_att: torch.Tensor, layer: int, n_layers: int, n_heads: int, out=None,
                     splits: int | None = None):
    """Layers ``layer`` and ``layer + 1`` (``layer`` even, ``n_layers``
    even) in one launch.  Arguments as
    :func:`~tpu_llama_torch.ops.fused_step2.fused_step2_layer` (``splits``
    for both layers' cells).  Returns (x_next f32 [B, D], attq_next int8
    [B, D], satt_next f32 [B], rows1, rows2): layer ``layer + 2``'s
    quantized attention input (not computed on the last pair) and the fresh
    rows (kq int8 [B, KVH, hd], ks f32 [B, KVH], vq, vs) of layers
    ``layer + 1`` and ``layer + 2`` for the step's flush; rows2 comes back
    untouched on the last pair.  ``out=(rows1, rows2)`` writes them into
    given contiguous tensors (the step's flush buffers; rows2 may be rows1
    on the last pair).  B <= 32 on the card.  K26 on CUDA tensors (one
    cooperative launch, on K12's grid), the plain version on CPU ones."""
    layer = int(layer)
    splits = _check_splits("fused_step3_pair", splits)
    B, D, H, QO = check_layer(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att, layer,
                              n_layers)
    if layer % 2 or n_layers % 2:
        raise ValueError(f"K26 pairs layers (l0, l0 + 1) from an even l0 of an even layer "
                         f"count, got layer {layer} of {n_layers}")
    L, Bc, KVH, S, hd = check_cache("fused_step3_pair", k_cache, v_cache, k_scale, v_scale, pos)
    step2_inputs(B, D, QO, L, Bc, KVH, hd, n_heads, n_layers, cos, sin)
    outs = [None, None] if out is None else list(out)
    tensors = (x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin, wo.q, w13.q,
               w2.q, wqkv.q, rms_ffn, rms_att) + tuple(t for o in outs if o is not None
                                                        for t in o)
    if _kernels.on_cpu("K26", *tensors):
        return fused_step3_pair_plain(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos,
                                      cos, sin, wo, w13, w2, wqkv, rms_ffn, rms_att, layer,
                                      n_layers, n_heads, outs, splits)
    G = n_heads // KVH
    if B > MAX_ROWS or G > 8 or hd > 128:
        raise NotImplementedError(f"K26 takes up to {MAX_ROWS} rows, 8 query heads per kv "
                                  f"head and head_dim <= 128, got B={B}, G={G}, hd={hd}")
    ts = _dma_block(S, None)
    n = fused_splits(B, KVH, ts, S) if splits is None else splits
    ch = launch_chunk("K26", k_cache, v_cache, hd, k_scale, v_scale)
    dev = x.device
    st = _kernels.stream(x)
    # the seam's x, attq and satt (layer l0 + 1's) are scratch
    sc = step2_scratch(dev, st, B, D, H, QO)
    _, _, *rows1 = _outputs(B, D, KVH, hd, dev, outs[0])
    attq_n, satt_n, *rows2 = _outputs(B, D, KVH, hd, dev, outs[1])
    x_next = torch.empty((B, D), dtype=torch.float32, device=dev)
    args, keep = step2_args(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin,
                            (wo, w13, w2, wqkv), rms_ffn, rms_att, layer, n_layers, sc["x_seam"],
                            (sc["attq_seam"], sc["satt_seam"], *rows1), G, ts, n, st)
    last2 = layer + 2 >= n_layers
    l1, l2 = layer + 1, min(layer + 2, n_layers - 1)
    rsz = rms_ffn.element_size()
    ra = keep[-1]  # rms_att in rms_ffn's dtype
    if B:
        _kernels.launch(
            "K26", *args, *_stacked_ptrs(wo, l1), *_stacked_ptrs(w13, l1),
            *_stacked_ptrs(w2, l1), *_stacked_ptrs(wqkv, l2), rms_ffn.data_ptr() + l1 * D * rsz,
            ra.data_ptr() + l2 * D * rsz, x_next.data_ptr(), attq_n.data_ptr(),
            satt_n.data_ptr(), *(t.data_ptr() for t in rows2), int(last2),
            min(layer + 2, L - 1), _kernels.k12_residency(B, G, hd, ts, ch), st)
    del keep
    return x_next, attq_n, satt_n, tuple(rows1), tuple(rows2)

"""mega2: one launch per decode layer with the next layer's attention
trailing its linear work (K12).

Port of tpu_llama/ops/fused_step2.py:537 ``fused_step2_layer``.  Launch
``l`` runs layer ``l``'s linear phases (K11's arithmetic, with h2 staged in
bf16, :217-224), then post-processes layer ``l + 1``'s q/k/v (q roped,
times 1/sqrt(hd), rounded to bf16; k roped and quantized per head; v
quantized per head, :245-296), attends over the cache rows below each
slot's position (K9's online softmax over 128-row key blocks, run on
``fused_splits`` spans of the rows and merged in order), merges the fresh
column and quantizes the attention output (:714-737) -- all inside the one
launch on the card (csrc/fused_step2.cuh).  The TPU's DMA descriptor chain
(``decode_dma_descs``, ``step2_plan``, :451-515) and its signed rope tables
(``rope_tables``, :518) are not carried: a CUDA block computes its cache
offsets from ``pos`` and rotates interleaved pairs directly.
"""

from __future__ import annotations

import functools

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.attention import (
    DECODE_SMS,
    SPLIT_MIN_ROWS,
    _check_splits,
    _dma_block,
    _fresh_tail_merge,
    check_cache,
    decode_split_softmax,
    launch_chunk,
    quantize_kv,
    split_workspace,
)
from tpu_llama_torch.ops.fused_layer import (
    MAX_ROWS,
    check_layer,
    layer_views,
    linear_phases_plain,
)
from tpu_llama_torch.ops.quant import (ChannelQuantTensor, quantize_activations_plain, rope_f32,
                                       sqrt_f32)

# (slot, kv head, split) items K12's, K26's and K27's cells aim at: 16 for
# each of the card's SMs, four for each of the grid's blocks (four an SM),
# which take them grid-stride and skip the splits past a slot's rows
FUSED_CELL_ITEMS = 16 * DECODE_SMS


def fused_splits(B: int, KVH: int, ts: int, S: int) -> int:
    """How many key-row splits K12's and K26's trailing cells (and K27's
    leading ones) run for B slots of KVH kv heads over a cache of S rows in
    key blocks of ``ts`` rows: one where the cache is short (S <= 512, as
    ``decode_splits``), else as many as bring the (slot, kv head, split)
    items to about FUSED_CELL_ITEMS, each split at least one key block.
    Unlike K9's rule it still splits where the (slot, kv head) cells alone
    cover the SMs (B * KVH >= 132): the persistent grid holds three to four
    blocks an SM, and a batch's longest slot would otherwise set the cells'
    time.  A
    function of the shapes alone, so the plain versions, the tests and both
    kernels split alike, and nothing reads the card.  Llama-2 7B (KVH 32,
    S 2048, ts 128): 8 at batch 8, 16 at batch 1, 2 at batch 32."""
    if S <= SPLIT_MIN_ROWS:
        return 1
    return max(1, min(FUSED_CELL_ITEMS // (B * KVH), -(-S // ts)))


@functools.lru_cache(maxsize=None)
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
                            n_heads: int, out=None, splits=None):
    """Plain version of K12 (its arguments and results are
    :func:`fused_step2_layer`'s): the cells' softmax on each of ``splits``
    spans of the rows (None: ``fused_splits``), merged in split order
    (``decode_split_softmax``); at one split the sequential block walk."""
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
    ts = _dma_block(S, None)
    if splits is None:
        splits = fused_splits(B, KVH, ts, S)
    acc, m, l = decode_split_softmax(qb, k_cache, v_cache, k_scale, v_scale, pos, layer + 1, ts,
                                     splits)
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
                      rms_att: torch.Tensor, layer: int, n_layers: int, n_heads: int, out=None,
                      splits: int | None = None):
    """Layer ``layer``'s linear work and layer ``layer + 1``'s attention.
    x, attq, satt, the weights and the rms rows as
    :func:`~tpu_llama_torch.ops.fused_layer.fused_layer_linear`; the INT8
    cache [L, B, KVH, S, hd] with f32 scales [L, B, KVH, S], read only; pos
    [B] (read on the device; int32 is taken as it is); cos, sin f32 [B,
    hd/2] at each slot's position.  Returns the JAX function's tuple
    (x_next f32 [B, D], attq_next int8 [B, D], satt_next f32 [B], kq int8
    [B, KVH, hd], ks f32 [B, KVH], vq, vs): the next launch's attention
    input and layer ``layer + 1``'s fresh K/V rows for the step's flush.
    ``out=(kq, ks, vq, vs)`` writes the rows into given contiguous tensors
    (e.g. one layer of the step's flush buffers).  At the last layer only
    x_next is computed: the other outputs come back untouched.  ``splits``:
    the key-row spans of the trailing cells (None: ``fused_splits``; at
    more than one, within 2^-8 of max |out| of the JAX function, as K9).
    B <= 32 on the card.  K12 on CUDA tensors (one cooperative launch), the
    plain version on CPU ones."""
    layer = int(layer)
    splits = _check_splits("fused_step2_layer", splits)
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
                                       n_layers, n_heads, out, splits)
    if B > MAX_ROWS or G > 8 or hd > 128:
        raise NotImplementedError(f"K12 takes up to {MAX_ROWS} rows, 8 query heads per kv "
                                  f"head and head_dim <= 128, got B={B}, G={G}, hd={hd}")
    ts = _dma_block(S, None)
    n = fused_splits(B, KVH, ts, S) if splits is None else splits
    dev = x.device
    st = _kernels.stream(x)
    x_next = torch.empty((B, D), dtype=torch.float32, device=dev)
    outs = _outputs(B, D, KVH, hd, dev, out)
    args, keep = step2_args(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin,
                            (wo, w13, w2, wqkv), rms_ffn, rms_att, layer, n_layers, x_next, outs,
                            G, ts, n, st)
    if B:
        _kernels.launch("K12", *args, st)
    del keep
    return (x_next, *outs)


def step2_workspace_words(B: int, D: int, H: int, QO: int) -> int:
    """Int32 words of a K11, K12, K26 or K27 launch's workspace
    (csrc/fused_step2.cuh make_phases): two layers' counters and the exit
    count, the row groups' tickets (16-column groups of wo, w2 and wqkv,
    8-column ones of w13), the int32 partials [32, D], [32, 2H], [32, D],
    [32, QO] (room for MAX_ROWS rows whatever B, so the layout stays put
    between launches), then h2 quantized [B, H] int8 (for MAX_ROWS rows)."""
    tickets = 2 * -(-D // 16) + -(-H // 8) + -(-QO // 16)
    return (160 + -(-tickets // 4) * 4 + MAX_ROWS * (2 * D + 2 * H + QO)
            + -(-MAX_ROWS * H // 4))


_WORKSPACES: dict[tuple, torch.Tensor] = {}
_SCRATCH: dict[tuple, dict] = {}


def step2_workspace(device, stream: int, D: int, H: int, QO: int) -> torch.Tensor:
    """The workspace of K11, K12, K26 and K27 launches of widths D, H, QO on
    ``stream`` of ``device``: ``step2_workspace_words`` int32 words made
    zero, which every launch leaves zero again but for its quantized h2
    (written before it is read); one per (card, stream, widths), since the
    layout follows the widths -- h2 quantized at one width's offset would
    lie in another width's tickets or partials, which a launch reads as
    zero.  Launches on one stream run in order."""
    key = (device, stream, D, H, QO)
    ws = _WORKSPACES.get(key)
    if ws is None:
        words = step2_workspace_words(MAX_ROWS, D, H, QO)
        ws = _WORKSPACES[key] = torch.zeros(words, dtype=torch.int32, device=device)
    return ws


def step2_scratch(device, stream: int, B: int, D: int, H: int, QO: int) -> dict:
    """Scratch that K11, K12, K26 and K27 launches on ``stream`` of
    ``device`` write and read inside a launch and return nothing of (qkv,
    att, xq, sx, h2 and K26's seam x, attq, satt): kept between launches,
    one set per (card, stream, shapes)."""
    key = (device, stream, B, D, H, QO)
    sc = _SCRATCH.get(key)
    if sc is None:
        f32 = dict(dtype=torch.float32, device=device)
        i8 = dict(dtype=torch.int8, device=device)
        sc = _SCRATCH[key] = dict(
            qkv=torch.empty((B, QO), **f32), att=torch.empty((B, D), **f32),
            xq=torch.empty((B, D), **i8), sx=torch.empty((B,), **f32),
            h2=torch.empty((B, H), **f32), x_seam=torch.empty((B, D), **f32),
            attq_seam=torch.empty((B, D), **i8), satt_seam=torch.empty((B,), **f32))
    return sc


def _stacked_ptrs(w: ChannelQuantTensor, i: int) -> tuple[int, int]:
    """The addresses of layer i's q and s in a stacked weight."""
    return (w.q.data_ptr() + i * w.q.stride(0) * w.q.element_size(),
            w.s.data_ptr() + i * w.s.stride(0) * w.s.element_size())


def step2_args(x, attq, satt, k_cache, v_cache, k_scale, v_scale, pos, cos, sin, weights,
               rms_ffn, rms_att, layer: int, n_layers: int, x_next, outs, G: int, ts: int,
               splits: int, stream: int):
    """tl_fused_step2_layer's arguments but the stream (see
    _kernels.SOURCES) for layer ``layer`` (its wqkv and rms_att those of
    layer + 1), and the tensors they point into that must outlive the
    launch's queueing."""
    wo, w13, w2, wqkv = weights
    if not all(t.is_contiguous() for w in weights for t in (w.q, w.s)) \
            or not (rms_ffn.is_contiguous() and rms_att.is_contiguous()):
        raise ValueError("the fused decode reads the weights where they lie: the stacked q, s "
                         "and rms rows must be contiguous")
    B, D = x.shape
    H, QO = w2.in_features, wqkv.out_features
    L, _, KVH, S, hd = k_cache.shape
    dev = x.device
    ch = launch_chunk("K12", k_cache, v_cache, hd, k_scale, v_scale)
    x, attq, satt = x.contiguous(), attq.contiguous(), satt.contiguous()
    cs, sn = cos.contiguous(), sin.contiguous()
    p32 = pos if pos.dtype == torch.int32 and pos.is_contiguous() else \
        pos.to(torch.int32).contiguous()
    ra = rms_att if rms_att.dtype == rms_ffn.dtype else rms_att.to(rms_ffn.dtype)
    nxt = min(layer + 1, n_layers - 1)
    rsz = rms_ffn.element_size()
    sc = step2_scratch(dev, stream, B, D, H, QO)
    ws = step2_workspace(dev, stream, D, H, QO)
    cws, ctk = split_workspace(B, KVH, G, hd, splits, dev, stream)
    args = [x.data_ptr(), attq.data_ptr(), satt.data_ptr(), *_stacked_ptrs(wo, layer),
            *_stacked_ptrs(w13, layer), *_stacked_ptrs(w2, layer), *_stacked_ptrs(wqkv, nxt),
            rms_ffn.data_ptr() + layer * D * rsz, ra.data_ptr() + nxt * D * rsz,
            _kernels.dtype_code(rms_ffn.dtype), x_next.data_ptr(), sc["qkv"].data_ptr(),
            sc["xq"].data_ptr(), sc["sx"].data_ptr(), sc["h2"].data_ptr(), ws.data_ptr(), B, D,
            H, QO, int(layer + 1 >= n_layers), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), p32.data_ptr(), cs.data_ptr(),
            sn.data_ptr(), sc["att"].data_ptr(), *(t.data_ptr() for t in outs),
            None if cws is None else cws.data_ptr(), None if ctk is None else ctk.data_ptr(),
            KVH, G, hd, S, min(layer + 1, L - 1), ts, splits, inv_sqrt_hd(hd), ch]
    return args, (x, attq, satt, cs, sn, p32, ra)

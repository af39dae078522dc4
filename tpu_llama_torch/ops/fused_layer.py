"""The fused W8A8 decode layer: one launch for all of a layer's linear work
(K11), one layer's product from stacked weights (K8), and the tensor-parallel
decode's two collective-free spans of a layer on the local shard: the FFN
(K23) and the next layer's qkv (K24).

Port of tpu_llama/ops/fused_layer.py: ``fused_layer_linear`` (:204),
``w8a8_matmul_stacked`` (:541), ``fused_ffn_stacked`` (:376) and
``fused_rms_qkv_stacked`` (:488).  Weights are the port's stacked K-major
``ChannelQuantTensor``s (``q [L, out, in]``) and the layer is a host int:
on the card a layer of a stacked tensor is a pointer offset, so K8 is K1's
kernel launched on the layer's view, counted under its own id.  No 32-row
padding: rows are independent and only real rows exist.  The TPU's VMEM
block planner (``_pick_fused_blocks``, :165-201) is a Mosaic rule and is not
carried.

Each plain version does its kernel's arithmetic step for step: the int8
products exact, every f32 product and sum rounded once (the kernels use
round-to-nearest intrinsics), K3's rmsnorm with its f64 sum of squares, K2's
row quant, and the SiLU spelled as the TPU kernel spells it,
``g * (1 / (1 + exp(-g))) * u`` (:126) -- not K4's ``silu(g) * u``.
"""

from __future__ import annotations

import torch

from tpu_llama_torch.ops import _kernels
from tpu_llama_torch.ops.matmul import _check, launch_w8a8, w8a8_matmul_prequant_plain
from tpu_llama_torch.ops.quant import (
    ChannelQuantTensor,
    _check_float,
    quantize_activations_plain,
    rmsnorm_quantize_plain,
)

MAX_ROWS = 32  # batch rows K11, K12, K26 and K27 take, and a row group of K23 and K24
# (csrc/fused_decode.cuh kMaxRows)


def w8a8_matmul_stacked_plain(xq, sx, w: ChannelQuantTensor, layer: int) -> torch.Tensor:
    """Plain version of K8: K1's plain version on layer ``layer``'s view."""
    return w8a8_matmul_prequant_plain(xq, sx, w.layer(layer))


def w8a8_matmul_stacked(xq: torch.Tensor, sx: torch.Tensor, w: ChannelQuantTensor,
                        layer: int) -> torch.Tensor:
    """xq int8 [M, IN], sx f32 [M], stacked w (q [L, OUT, IN]) -> f32
    [M, OUT]: ``(f32(xq . w[layer]) * sx) * w.s[layer]``.  K8 (K1's kernel on
    the layer's view) on CUDA tensors, the plain version on CPU ones."""
    wl = w.layer(int(layer))
    _check(xq, sx, wl)
    if _kernels.on_cpu("K8", xq, sx, wl.q, wl.s):
        return w8a8_matmul_stacked_plain(xq, sx, w, int(layer))
    return launch_w8a8("K8", xq, sx, wl, torch.float32)


def silu_mul_f32(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``g * (1 / (1 + exp(-g))) * u`` in f32, each step rounded."""
    return g * (1.0 / (1.0 + torch.exp(-g))) * u


def linear_phases_plain(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att, last: bool,
                        bf16_h2: bool = False):
    """Phases A-D of one layer on the layer's views (wqkv and rms_att of
    layer l + 1): (x_next f32 [B, D], qkv f32 [B, QO], or None when
    ``last``).  ``bf16_h2`` rounds h2 to bf16 before its quant (K12)."""
    H = w2.in_features
    x2 = w8a8_matmul_prequant_plain(attq, satt, wo, residual=x)
    hq, hs = rmsnorm_quantize_plain(x2, rms_ffn)
    gu = w8a8_matmul_prequant_plain(hq, hs, w13)
    h2 = silu_mul_f32(gu[:, :H], gu[:, H:])
    if bf16_h2:
        h2 = h2.to(torch.bfloat16).float()
    q3, s3 = quantize_activations_plain(h2)
    x_next = w8a8_matmul_prequant_plain(q3, s3, w2, residual=x2)
    if last:
        return x_next, None
    q4, s4 = rmsnorm_quantize_plain(x_next, rms_att)
    return x_next, w8a8_matmul_prequant_plain(q4, s4, wqkv)


def check_layer(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers):
    """Validate a fused-layer call; returns (B, D, H, QO)."""
    B, D, H, QO = check_stack(x, wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    if attq.shape != (B, D) or attq.dtype != torch.int8:
        raise ValueError(f"want attq int8 [{B}, {D}], got {attq.dtype} {tuple(attq.shape)}")
    if satt.shape != (B,) or satt.dtype != torch.float32:
        raise ValueError(f"want satt f32 [{B}], got {satt.dtype} {tuple(satt.shape)}")
    return B, D, H, QO


def check_stack(x, wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers):
    """Validate the residual x f32 [B, D], the stacked weights and rms rows
    and the layer of a fused-layer call; returns (B, D, H, QO)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"want x f32 [B, D], got {x.dtype} {tuple(x.shape)}")
    B, D = x.shape
    ws = (wo, w13, w2, wqkv)
    if not all(isinstance(w, ChannelQuantTensor) and w.q.dim() == 3 for w in ws):
        raise TypeError("wo, w13, w2 and wqkv must be stacked ChannelQuantTensors (q [L, out, in])")
    L = wo.q.shape[0]
    H = w2.in_features
    QO = wqkv.out_features
    if (wo.q.shape != (L, D, D) or w13.q.shape != (L, 2 * H, D) or w2.q.shape != (L, D, H)
            or wqkv.q.shape != (L, QO, D) or n_layers != L):
        raise ValueError(f"stacked weights disagree: wo {tuple(wo.q.shape)}, w13 "
                         f"{tuple(w13.q.shape)}, w2 {tuple(w2.q.shape)}, wqkv "
                         f"{tuple(wqkv.q.shape)}, n_layers {n_layers}")
    if rms_ffn.shape != (L, D) or rms_att.shape != (L, D):
        raise ValueError(f"want rms_ffn and rms_att [{L}, {D}]")
    _check_float("fused layer rms weights", rms_ffn, rms_att)
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    return B, D, H, QO


def layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer: int, n_layers: int):
    """Layer ``layer``'s wo, w13, w2 and rms_ffn with layer l + 1's wqkv and
    rms_att (layer ``layer``'s at the last layer, where they go unused)."""
    nxt = min(layer + 1, n_layers - 1)
    return (wo.layer(layer), w13.layer(layer), w2.layer(layer), wqkv.layer(nxt),
            rms_ffn[layer], rms_att[nxt])


def launch_args(x, attq, satt, views, x_next, qkv, B, D, H, QO, last, stream: int):
    """tl_fused_layer_linear's arguments but the stream (see
    _kernels.SOURCES), which tl_fused_step_layer takes too without attq and
    satt, and the tensors they point into that must outlive the launch's
    queueing.  The scratch (xq, sx, h2) and the workspace are the streaming
    body's, kept per (card, stream, widths) by ops/fused_step2.py and shared
    with K12, K26 and K27: each launch leaves the workspace zero but for its
    quantized h2, and launches on one stream run in order."""
    # imported here: ops/fused_step2.py imports this module
    from tpu_llama_torch.ops.fused_step2 import step2_scratch, step2_workspace

    wo, w13, w2, wqkv, rf, ra = views
    if not all(t.is_contiguous() for w in (wo, w13, w2, wqkv) for t in (w.q, w.s)):
        raise ValueError("the fused decode reads the weights where they lie: each layer's "
                         "q and s must be contiguous")
    dev = x.device
    sc = step2_scratch(dev, stream, B, D, H, QO)
    ws = step2_workspace(dev, stream, D, H, QO)
    if rf.dtype != ra.dtype:
        ra = ra.to(rf.dtype)
    args = [x.data_ptr(), attq.data_ptr(), satt.data_ptr()]
    for w in (wo, w13, w2, wqkv):
        args += [w.q.data_ptr(), w.s.data_ptr()]
    args += [rf.data_ptr(), ra.data_ptr(), _kernels.dtype_code(rf.dtype), x_next.data_ptr(),
             qkv.data_ptr(), sc["xq"].data_ptr(), sc["sx"].data_ptr(), sc["h2"].data_ptr(),
             ws.data_ptr(), B, D, H, QO, int(last)]
    return args, ra


def fused_layer_linear_plain(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att, layer: int,
                             n_layers: int, qkv_out=None):
    """Plain version of K11 (its arguments and results are
    :func:`fused_layer_linear`'s)."""
    views = layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    last = layer + 1 >= n_layers
    x_next, qkv = linear_phases_plain(x, attq, satt, *views, last=last)
    if qkv_out is None:
        qkv_out = torch.empty((x.shape[0], wqkv.out_features), dtype=torch.float32,
                              device=x.device)
    if qkv is not None:
        qkv_out.copy_(qkv)
    return x_next, qkv_out


def fused_layer_linear(x: torch.Tensor, attq: torch.Tensor, satt: torch.Tensor,
                       wo: ChannelQuantTensor, w13: ChannelQuantTensor, w2: ChannelQuantTensor,
                       wqkv: ChannelQuantTensor, rms_ffn: torch.Tensor, rms_att: torch.Tensor,
                       layer: int, n_layers: int, qkv_out: torch.Tensor | None = None):
    """All of decode layer ``layer``'s linear work: x f32 [B, D] (the
    residual entering the layer), attq int8 [B, D] and satt f32 [B] (its
    quantized attention output), the stacked wo, w13 ([gate|up]), w2 and
    wqkv ([q|k|v]), rms_ffn and rms_att [L, D], ``layer`` a host int.
    Returns (x_next f32 [B, D], qkv_next f32 [B, D + 2 KVD]): the layer's
    output and layer ``layer + 1``'s qkv projection of it.  At the last
    layer qkv_next is not computed: the buffer (``qkv_out``, or a new
    uninitialized one) comes back untouched.  B <= 32 on the card.  K11 on
    CUDA tensors (one cooperative launch on csrc/fused_step2.cuh's streaming
    body, h2 in f32), the plain version on CPU ones."""
    layer = int(layer)
    B, D, H, QO = check_layer(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att, layer,
                              n_layers)
    if qkv_out is not None and (qkv_out.shape != (B, QO) or qkv_out.dtype != torch.float32):
        raise ValueError(f"want qkv_out f32 [{B}, {QO}]")
    tensors = (x, attq, satt, wo.q, w13.q, w2.q, wqkv.q, rms_ffn, rms_att) + (
        () if qkv_out is None else (qkv_out,))
    if _kernels.on_cpu("K11", *tensors):
        return fused_layer_linear_plain(x, attq, satt, wo, w13, w2, wqkv, rms_ffn, rms_att,
                                        layer, n_layers, qkv_out)
    if B > MAX_ROWS:
        raise NotImplementedError(f"K11 takes up to {MAX_ROWS} rows, got {B}")
    views = layer_views(wo, w13, w2, wqkv, rms_ffn, rms_att, layer, n_layers)
    x, attq, satt = x.contiguous(), attq.contiguous(), satt.contiguous()
    x_next = torch.empty((B, D), dtype=torch.float32, device=x.device)
    qkv = qkv_out if qkv_out is not None else torch.empty((B, QO), dtype=torch.float32,
                                                          device=x.device)
    if not qkv.is_contiguous():
        raise ValueError("qkv_out must be contiguous")
    st = _kernels.stream(x)
    args, keep = launch_args(x, attq, satt, views, x_next, qkv, B, D, H, QO,
                             layer + 1 >= n_layers, st)
    if B:
        _kernels.launch("K11", *args, st)
    del keep
    return x_next, qkv


# ---------------------------------------------------------------------------
# The TP sub-span kernels (fused_layer.py:319-538).  Megatron TP needs an
# all-reduce after wo and after w2, so K11's whole-layer fusion cannot run
# under tensor parallelism; its collective-free spans can, each one launch
# on the local shard: K23 (rms, quant, w13, SiLU x up, quant, the w2
# partial) and K24 (rms, quant, the local qkv).  Both run K11's streaming
# body (csrc/fused_step2.cuh) over phases B-C and D, entered from x.  Any
# row count in one launch: groups of MAX_ROWS rows one after another, each
# with counters, tickets and partials of its own, as JAX's TP path has no
# fallback.
# ---------------------------------------------------------------------------

# The streaming body's geometry for the spans (csrc/fused_step2.cuh kRowsU,
# kSpanChunk, kSpanPitch, kFlowWords): a unit is 16 weight rows (w13: the
# gate and up rows of 8 columns) by 2 KB of K, a stage row 2112 bytes apart;
# a row group's counters take 64 int32 words.
ROWS_U, SPAN_CHUNK, SPAN_PITCH, FLOW_WORDS = 16, 2048, 2112, 64


def span_act_width(K: int) -> int:
    """Bytes a row of a span's int8 activations of width K takes
    (csrc/fused_step2.cuh span_act_width): chunk-major, each SPAN_CHUNK of
    K in a run of SPAN_PITCH bytes, so that one bulk copy brings a unit's
    activation rows into a stage."""
    return -(-K // SPAN_CHUNK) * SPAN_PITCH


def span_phases(kernel: str, D: int, N: int):
    """The phases of a K23 (N = Hl) or K24 (N = QOl) launch, in order: a
    tuple of (weight, row groups, SPAN_CHUNK chunks of K, int32 partial
    columns) per phase (csrc/fused_step2.cuh phase_groups, lay_phases)."""
    if kernel == "K23":
        return (("w13", -(-N // 8), -(-D // SPAN_CHUNK), 2 * N),
                ("w2", -(-D // ROWS_U), -(-N // SPAN_CHUNK), D))
    if kernel == "K24":
        return (("wqkv", -(-N // ROWS_U), -(-D // SPAN_CHUNK), N),)
    raise ValueError(f"no span kernel {kernel!r}")


def span_layout(kernel: str, B: int, D: int, N: int) -> dict:
    """The int32 workspace of a K23 or K24 launch of B rows (csrc/
    fused_step2.cuh make_span, span_group): ``groups`` row groups of up to
    MAX_ROWS rows, one Flow of FLOW_WORDS words each from word 0, the exit
    count at ``exit``, then from ``tickets`` on each row group's ``stride``
    words -- the tickets of its phases (padded to 4) and their partials
    [MAX_ROWS, columns] -- and ``words`` in all.  All zero between
    launches."""
    groups = max(1, -(-B // MAX_ROWS))
    phases = span_phases(kernel, D, N)
    tickets = sum(g for _, g, _, _ in phases)
    stride = -(-tickets // 4) * 4 + MAX_ROWS * sum(c for _, _, _, c in phases)
    base = groups * FLOW_WORDS + 32
    return dict(groups=groups, exit=groups * FLOW_WORDS, tickets=base, stride=stride,
                words=base + groups * stride)


_SPAN_WS: dict[tuple, torch.Tensor] = {}
_SPAN_SCRATCH: dict[tuple, tuple] = {}


def span_workspace(device, stream: int, kernel: str, B: int, D: int, N: int) -> torch.Tensor:
    """The workspace of K23 or K24 launches of B rows and widths D, N on
    ``stream`` of ``device``: ``span_layout`` words made zero, which every
    launch leaves zero; one per (card, stream, kernel, widths, row groups),
    apart from K11's and K12's (``ops.fused_step2.step2_workspace``, which
    also holds their quantized h2).  Launches on one stream run in order."""
    lay = span_layout(kernel, B, D, N)
    key = (device, stream, kernel, D, N, lay["groups"])
    ws = _SPAN_WS.get(key)
    if ws is None:
        ws = _SPAN_WS[key] = torch.zeros(lay["words"], dtype=torch.int32, device=device)
    return ws


def span_scratch(device, stream: int, kernel: str, B: int, D: int, N: int) -> tuple:
    """Scratch a K23 launch writes and reads inside the launch (xq int8,
    sx f32 [B], h2 f32 [B, Hl], xq3 int8; the int8 rows ``span_act_width``
    bytes each) or a K24 launch (xq, sx): kept between launches, one set per
    (card, stream, kernel, shapes)."""
    key = (device, stream, kernel, B, D, N)
    sc = _SPAN_SCRATCH.get(key)
    if sc is None:
        i8, f32 = dict(dtype=torch.int8, device=device), dict(dtype=torch.float32, device=device)
        sc = (torch.empty((B, span_act_width(D)), **i8), torch.empty((B,), **f32))
        if kernel == "K23":
            sc += (torch.empty((B, N), **f32), torch.empty((B, span_act_width(N)), **i8))
        sc = _SPAN_SCRATCH[key] = sc
    return sc


def _check_tp_span(name, x, ws, rms, layer):
    """Validate x f32 [B, D], stacked ChannelQuantTensors ``ws`` and
    rms [L, D]; returns (B, D, L)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"{name}: want x f32 [B, D], got {x.dtype} {tuple(x.shape)}")
    B, D = x.shape
    if not all(isinstance(w, ChannelQuantTensor) and w.q.dim() == 3 for w in ws):
        raise TypeError(f"{name}: the weights must be stacked ChannelQuantTensors "
                        "(q [L, out, in])")
    L = ws[0].q.shape[0]
    if rms.shape != (L, D):
        raise ValueError(f"{name}: want rms [{L}, {D}], got {tuple(rms.shape)}")
    _check_float(f"{name} rms weights", rms)
    if not 0 <= layer < L:
        raise ValueError(f"{name}: layer {layer} outside [0, {L})")
    return B, D, L


def fused_ffn_stacked_plain(x, w13: ChannelQuantTensor, w2: ChannelQuantTensor, rms_ffn,
                            layer: int) -> torch.Tensor:
    """Plain version of K23: K11's phases B and C on layer ``layer`` without
    the residual."""
    H = w2.in_features
    hq, hs = rmsnorm_quantize_plain(x, rms_ffn[layer])
    gu = w8a8_matmul_prequant_plain(hq, hs, w13.layer(layer))
    q3, s3 = quantize_activations_plain(silu_mul_f32(gu[:, :H], gu[:, H:]))
    return w8a8_matmul_prequant_plain(q3, s3, w2.layer(layer))


def fused_ffn_stacked(x: torch.Tensor, w13: ChannelQuantTensor, w2: ChannelQuantTensor,
                      rms_ffn: torch.Tensor, layer) -> torch.Tensor:
    """rms -> quant -> w13 -> SiLU x up -> quant -> w2 in one launch on the
    local shard: x f32 [B, D] (the full residual stream, replicated), the
    stacked local w13 ([gate_i | up_i], q [L, 2 Hl, D]) and w2 (q [L, D,
    Hl]), rms_ffn [L, D], ``layer`` a host int.  Returns the w2 PARTIAL
    f32 [B, D]: the caller all-reduces it and adds the residual.  K23 on
    CUDA tensors (one cooperative launch on csrc/fused_step2.cuh's streaming
    body, phases B and C, any B), the plain version on CPU ones."""
    layer = int(layer)
    B, D, L = _check_tp_span("fused_ffn_stacked", x, (w13, w2), rms_ffn, layer)
    H = w2.in_features
    if w13.q.shape != (L, 2 * H, D) or w2.q.shape != (L, D, H):
        raise ValueError(f"fused_ffn_stacked: w13 {tuple(w13.q.shape)} and w2 "
                         f"{tuple(w2.q.shape)} disagree with x [{B}, {D}]")
    if _kernels.on_cpu("K23", x, w13.q, w2.q, rms_ffn):
        return fused_ffn_stacked_plain(x, w13, w2, rms_ffn, layer)
    w13l, w2l = w13.layer(layer), w2.layer(layer)
    if not all(t.is_contiguous() for w in (w13l, w2l) for t in (w.q, w.s)):
        raise ValueError("K23 reads the weights where they lie: each layer's q and s must be "
                         "contiguous")
    x = x.contiguous()
    rf = rms_ffn[layer].contiguous()
    dev = x.device
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B:
        st = _kernels.stream(x)
        xq, sx, h2, xq3 = span_scratch(dev, st, "K23", B, D, H)
        ws = span_workspace(dev, st, "K23", B, D, H)
        _kernels.launch("K23", x.data_ptr(), w13l.q.data_ptr(), w13l.s.data_ptr(),
                        w2l.q.data_ptr(), w2l.s.data_ptr(), rf.data_ptr(),
                        _kernels.dtype_code(rf.dtype), out.data_ptr(), xq.data_ptr(),
                        sx.data_ptr(), h2.data_ptr(), xq3.data_ptr(), ws.data_ptr(), B, D, H, st)
    return out


def fused_rms_qkv_stacked_plain(x, wqkv: ChannelQuantTensor, rms_att, layer: int):
    """Plain version of K24: K11's phase D on layer ``layer``."""
    q, s = rmsnorm_quantize_plain(x, rms_att[layer])
    return w8a8_matmul_prequant_plain(q, s, wqkv.layer(layer))


def fused_rms_qkv_stacked(x: torch.Tensor, wqkv: ChannelQuantTensor, rms_att: torch.Tensor,
                          layer) -> torch.Tensor:
    """rms -> quant -> qkv in one launch on the local shard: x f32 [B, D],
    the stacked local wqkv ([q_i | k_i | v_i], q [L, QOl, D]), rms_att
    [L, D], ``layer`` a host int.  Returns f32 [B, QOl].  K24 on CUDA
    tensors (one cooperative launch on the streaming body, phase D, any B),
    the plain version on CPU ones."""
    layer = int(layer)
    B, D, L = _check_tp_span("fused_rms_qkv_stacked", x, (wqkv,), rms_att, layer)
    QO = wqkv.out_features
    if wqkv.q.shape != (L, QO, D):
        raise ValueError(f"fused_rms_qkv_stacked: wqkv {tuple(wqkv.q.shape)} disagrees with x "
                         f"[{B}, {D}]")
    if _kernels.on_cpu("K24", x, wqkv.q, rms_att):
        return fused_rms_qkv_stacked_plain(x, wqkv, rms_att, layer)
    wl = wqkv.layer(layer)
    if not (wl.q.is_contiguous() and wl.s.is_contiguous()):
        raise ValueError("K24 reads the weights where they lie: each layer's q and s must be "
                         "contiguous")
    x = x.contiguous()
    ra = rms_att[layer].contiguous()
    dev = x.device
    out = torch.empty((B, QO), dtype=torch.float32, device=dev)
    if B:
        st = _kernels.stream(x)
        xq, sx = span_scratch(dev, st, "K24", B, D, QO)
        ws = span_workspace(dev, st, "K24", B, D, QO)
        _kernels.launch("K24", x.data_ptr(), wl.q.data_ptr(), wl.s.data_ptr(), ra.data_ptr(),
                        _kernels.dtype_code(ra.dtype), out.data_ptr(), xq.data_ptr(),
                        sx.data_ptr(), ws.data_ptr(), B, D, QO, st)
    return out

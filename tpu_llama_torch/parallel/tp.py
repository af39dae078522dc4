"""Explicit tensor-parallel decode and prefill over ``torch.distributed``.

Port of tpu_llama/parallel/tp.py.  JAX places the collectives by hand under
``shard_map``; here every rank runs the same function on its own shard
(SPMD), with the collectives of ``parallel.mesh``:

* every product runs on the LOCAL weight shard (``shard_params``), kernels
  included;
* the two row-sharded projections (wo, w2) give partial sums reduced with
  one all-reduce each over the ``model`` axis: the Megatron schedule, two
  collectives per layer;
* the embedding gather runs vocab-sharded (a masked local gather, then an
  all-reduce), and so does the classifier, whose logits are all-gathered
  to [B, V] on every rank (over ``model``, then ``data``), so that every
  rank's host sees the same logits and takes the same decisions.

Each entry point takes the GLOBAL batch (tokens, positions, lengths; the
same on every rank) and this rank's local cache [L, B / dp, KVH / tp, S,
hd]; a rank computes the rows of its ``data`` index.  Requires n_kv_heads,
hidden_dim and vocab_size divisible by the model-axis size and the batch by
the data-axis size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models.llama import (
    LlamaParams,
    QuantKVCache,
    _attend_decode,
    _attend_fresh,
    _cache_rows,
    _decode_attend,
    _decode_prologue,
    _flush,
    _flush_buffers,
    _last_rows,
    _split_rope,
    _write_decode,
    _write_rows,
    apply_rope,
    make_kv_cache,
    matmul_any,
    prefill_attention,
    rmsnorm,
)
from tpu_llama_torch.ops.attention import kv_cache_scatter_slots
from tpu_llama_torch.ops.fused_layer import (
    fused_ffn_stacked,
    fused_rms_qkv_stacked,
    w8a8_matmul_stacked,
)
from tpu_llama_torch.ops.quant import ChannelQuantTensor, QuantTensor, quantize_activations
from tpu_llama_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather, all_reduce
from tpu_llama_torch.parallel.overlap import collective_matmul_rowsharded

TP_ATTN = ("auto", "flash", "xla")


def _local_width(w) -> int:
    """The local output width of a weight shard (JAX's physical trailing
    width): a quantized tensor's stored out rows, a dense one's last dim."""
    if isinstance(w, (ChannelQuantTensor, QuantTensor)):
        return w.q.shape[-2]
    return w.shape[-1]


def _local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """Per-shard view for the attention shapes: heads (and the head width
    ``dim`` they span) divided by tp; ``head_dim`` is invariant."""
    return ModelConfig(dim=config.dim // tp, hidden_dim=config.hidden_dim // tp,
                       n_layers=config.n_layers, n_heads=config.n_heads // tp,
                       n_kv_heads=config.n_kv_heads // tp, vocab_size=config.vocab_size,
                       seq_len=config.seq_len, shared_weights=config.shared_weights)


def _check_mesh(config: ModelConfig, mesh: Mesh) -> int:
    tp = mesh.size(MODEL_AXIS)
    if config.n_kv_heads % tp or config.hidden_dim % tp or config.vocab_size % tp:
        raise ValueError(f"n_kv_heads {config.n_kv_heads}, hidden_dim {config.hidden_dim} and "
                         f"vocab_size {config.vocab_size} must split over tp={tp}")
    return tp


def _refuse_padded(params: LlamaParams, name: str) -> None:
    """Quantization padding would split across shards (the pad columns all
    land on the last one); real Llama dims never pad (tp.py:96-113)."""
    lp = params.layers
    for w in (params.wcls, lp.wq, lp.wk, lp.wv, lp.wo, lp.w1, lp.w2, lp.w3):
        if isinstance(w, QuantTensor) and (w.padded_in != w.logical_in
                                           or w.padded_out != w.logical_out):
            raise ValueError(f"{name} requires padding-free QuantTensors (got padded "
                             f"{w.padded_in}x{w.padded_out} vs logical {w.logical_in}x"
                             f"{w.logical_out}); use kernel-aligned model dims or a smaller "
                             "quant group")


def _data_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n``."""
    dp = mesh.size(DATA_AXIS)
    if n % dp:
        raise ValueError(f"a batch of {n} does not split over dp={dp}")
    per = n // dp
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def _embed(params: LlamaParams, tokens, vocab_local: int, mesh: Mesh, dtype=None):
    """The vocab-sharded embedding gather: this rank's rows of ``tok_emb``
    where a token lies in its vocab shard, zeros elsewhere, all-reduced
    over ``model`` (in ``dtype``, default ``tok_emb``'s)."""
    ids = tokens.long() - mesh.model_index * vocab_local
    inside = (ids >= 0) & (ids < vocab_local)
    rows = params.tok_emb[ids.clamp(0, vocab_local - 1)]
    part = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype))
    return all_reduce(part if dtype is None else part.to(dtype), mesh)


def _gather_logits(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's vocab-sharded logits [b, ..., V / tp] -> the global
    [B, ..., V] on every rank: all-gathered over ``model``, then ``data``."""
    full = all_gather(logits, mesh, MODEL_AXIS, dim=-1)
    return all_gather(full, mesh, DATA_AXIS, dim=0)


def _resolve_attn(attn: str, cache) -> str:
    """``"auto"`` is ``"flash"`` on the card (K21 on the decode, K6 on the
    prefill), as on the TPU, and ``"xla"`` on the CPU."""
    if attn not in TP_ATTN:
        raise ValueError(f"TP attention {attn!r}: want one of {TP_ATTN}")
    if attn == "auto":
        return "flash" if cache.k.is_cuda else "xla"
    return attn


def _qkv(h, lp, local: ModelConfig, precision: str):
    """The local q, k, v: the shard-interleaved fused wqkv
    (``fuse_projections(tp=...)``), found by its local width, or three
    products."""
    Dl, KVDl = local.dim, local.kv_dim
    if _local_width(lp.wq) == Dl + 2 * KVDl:
        qkv = matmul_any(h, lp.wq, precision=precision)
        return qkv[..., :Dl], qkv[..., Dl:Dl + KVDl], qkv[..., Dl + KVDl:]
    return tuple(matmul_any(h, w, precision=precision) for w in (lp.wq, lp.wk, lp.wv))


def _ffn_hidden(h, lp, local: ModelConfig, precision: str):
    """silu(gate) * up on the local hidden columns (the fused [w1_i | w3_i]
    found by its local width)."""
    Hl = local.hidden_dim
    if _local_width(lp.w1) == 2 * Hl:
        gu = matmul_any(h, lp.w1, precision=precision)
        gate, up = gu[..., :Hl], gu[..., Hl:]
    else:
        gate, up = (matmul_any(h, w, precision=precision) for w in (lp.w1, lp.w3))
    return F.silu(gate) * up


def _row_sharded(a, w, mesh: Mesh, precision: str, overlap: bool):
    """``sum_s(a_s @ w_s)`` over ``model``: the ring collective matmul for a
    dense weight with ``overlap``, else the local product and one
    all-reduce."""
    if overlap and isinstance(w, torch.Tensor):
        return collective_matmul_rowsharded(a, w, mesh, precision)
    return all_reduce(matmul_any(a, w, precision=precision), mesh)


def tp_forward_decode(params: LlamaParams, cache, tokens: torch.Tensor, pos: torch.Tensor,
                      config: ModelConfig, mesh: Mesh, precision: str = "default",
                      attn: str = "auto", overlap: bool = False):
    """The explicit-TP decode step (tp.py:76-188): this rank's shard of
    ``params``, its local cache (INT8 or fp, updated in place), the global
    tokens and positions [B].  Per layer: the local qkv, RoPE, the step's
    row written (``_write_decode``), then the write-then-attend attention on
    the local heads -- K21 for ``attn="flash"`` (``"auto"`` on the card),
    the dequantized plain attention for ``"xla"`` (``"auto"`` on the CPU)
    -- and the wo and w2 partials all-reduced (``overlap=True``: the ring
    collective matmul, dense weights only).  The embedding keeps
    ``tok_emb``'s dtype.  Returns (logits f32 [B, V] on every rank,
    cache)."""
    attn = _resolve_attn(attn, cache)
    tp = _check_mesh(config, mesh)
    _refuse_padded(params, "tp_forward_decode")
    local = _local_config(config, tp)
    rows = _data_rows(tokens.shape[0], mesh)
    tok, p = tokens[rows], pos[rows].long()
    B, NHl, KVHl, hd = tok.shape[0], local.n_heads, local.n_kv_heads, local.head_dim
    x = _embed(params, tok, config.vocab_size // tp, mesh)
    cos, sin = params.rope_cos[p], params.rope_sin[p]
    for i in range(params.layers.rms_att.shape[0]):
        lp = params.layers.layer(i)
        q, k, v = _qkv(rmsnorm(x, lp.rms_att), lp, local, precision)
        q = apply_rope(q.reshape(B, NHl, hd), cos, sin)
        k = apply_rope(k.reshape(B, KVHl, hd), cos, sin)
        _write_decode(cache, i, k, v.reshape(B, KVHl, hd), p, local)
        att = _attend_decode(cache, i, q, p, local, attn)
        x = x + _row_sharded(att, lp.wo, mesh, precision, overlap)
        hidden = _ffn_hidden(rmsnorm(x, lp.rms_ffn), lp, local, precision)
        x = x + _row_sharded(hidden, lp.w2, mesh, precision, overlap)
    logits = matmul_any(rmsnorm(x, params.rms_final), params.wcls, precision=precision).float()
    return _gather_logits(logits, mesh), cache


def _tp_prefill_body(params: LlamaParams, cache, tokens, start_pos, lengths, *,
                     local: ModelConfig, vocab_local: int, mesh: Mesh, precision: str, attn: str,
                     logits_mode: str):
    """The per-rank prefill (tp.py:192-347) over this rank's rows: tokens
    [b, T] at positions start_pos[b] + t; each layer's local K/V written in
    place at those positions (``_write_rows``: quantized for an INT8 cache,
    cast for an fp one; a position past the cache is not written), the
    attention over the local heads of the layer's cache (K6 for
    ``attn="flash"``, ``attention_prefill`` for ``"xla"``), the Megatron
    all-reduces.  Returns (this rank's vocab-sharded logits, cache)."""
    B, T = tokens.shape
    S = cache.k.shape[3]
    NHl, KVHl, hd = local.n_heads, local.n_kv_heads, local.head_dim
    start = start_pos.to(device=tokens.device, dtype=torch.int32)
    fits = int(start.max()) + T <= S
    x = _embed(params, tokens, vocab_local, mesh)  # [B, T, D]
    write_pos = (start.long()[:, None] + torch.arange(T, device=tokens.device)).clamp(0, S - 1)
    cos, sin = params.rope_cos[write_pos], params.rope_sin[write_pos]
    attend = prefill_attention(attn)
    for i in range(params.layers.rms_att.shape[0]):
        lp = params.layers.layer(i)
        q, k, v = _qkv(rmsnorm(x, lp.rms_att), lp, local, precision)
        q = apply_rope(q.reshape(B, T, NHl, hd), cos, sin)
        k = apply_rope(k.reshape(B, T, KVHl, hd), cos, sin)
        _write_rows(cache, i, _cache_rows(cache, k, v.reshape(B, T, KVHl, hd)), start, local,
                    fits)
        scales = (cache.ks[i], cache.vs[i]) if isinstance(cache, QuantKVCache) else ()
        att = attend(q, cache.k[i], cache.v[i], start, *scales, out_dtype=x.dtype)
        x = x + all_reduce(matmul_any(att, lp.wo, precision=precision), mesh)
        hidden = _ffn_hidden(rmsnorm(x, lp.rms_ffn), lp, local, precision)
        x = x + all_reduce(matmul_any(hidden, lp.w2, precision=precision), mesh)
    if logits_mode == "last":
        x = _last_rows(x, lengths, T)
    return matmul_any(rmsnorm(x, params.rms_final), params.wcls, precision=precision).float(), \
        cache


def tp_forward_prefill(params: LlamaParams, cache, tokens: torch.Tensor,
                       start_pos: torch.Tensor, lengths: torch.Tensor, config: ModelConfig,
                       mesh: Mesh, precision: str = "default", logits_mode: str = "last",
                       attn: str = "auto"):
    """Explicit-TP batched causal prefill (tp.py:192-242): the global
    tokens [B, T], start positions and lengths [B]; this rank's local cache
    updated in place.  Needed because a single-program prefill cannot split
    ``fuse_projections(tp=...)``'s shard-interleaved columns.  JAX's
    ``max_keys`` (a bound on the keys its TPU kernel visits) is not carried:
    K6 stops at each query's own position.  Returns (logits [B, V] for
    ``logits_mode="last"`` or [B, T, V] for ``"all"``, on every rank;
    cache)."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    attn = _resolve_attn(attn, cache)
    tp = _check_mesh(config, mesh)
    _refuse_padded(params, "tp_forward_prefill")
    rows = _data_rows(tokens.shape[0], mesh)
    logits, cache = _tp_prefill_body(
        params, cache, tokens[rows], start_pos[rows], lengths[rows].long(),
        local=_local_config(config, tp), vocab_local=config.vocab_size // tp, mesh=mesh,
        precision=precision, attn=attn, logits_mode=logits_mode)
    return _gather_logits(logits, mesh), cache


def tp_prefill_into_slots(params: LlamaParams, cache, tokens: torch.Tensor,
                          lengths: torch.Tensor, slots, config: ModelConfig, mesh: Mesh,
                          precision: str = "default", attn: str = "auto",
                          logits_mode: str = "last"):
    """The explicit-TP admission (tp.py:350-423): fresh prompts [n, T]
    prefilled into a compact local cache of T rows, then landed in the local
    slot cache by K7 (``slots`` on the host), every bucket (the TPU's
    ``T % 128`` gate is a Mosaic rule).  dp = 1 only: the slots index the
    whole batch.  Returns (last-token logits [n, V], or every position's
    [n, T, V] for ``logits_mode="all"``, on every rank; cache)."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    if mesh.size(DATA_AXIS) != 1:
        raise ValueError("tp_prefill_into_slots is dp=1-only")
    attn = _resolve_attn(attn, cache)
    tp = _check_mesh(config, mesh)
    _refuse_padded(params, "tp_prefill_into_slots")
    local = _local_config(config, tp)
    n, T = tokens.shape
    small = make_kv_cache(local, n, kv_dtype=cache.k.dtype, seq_len=T, device=tokens.device)
    logits, small = _tp_prefill_body(
        params, small, tokens, torch.zeros(n, dtype=torch.int32, device=tokens.device),
        lengths.long(), local=local, vocab_local=config.vocab_size // tp, mesh=mesh,
        precision=precision, attn=attn, logits_mode=logits_mode)
    kv_cache_scatter_slots(small.k, small.v, slots, cache.k, cache.v, small.ks, small.vs,
                           cache.ks, cache.vs)
    return _gather_logits(logits, mesh), cache


def tp_forward_decode_fused(params: LlamaParams, cache, tokens: torch.Tensor,
                            pos: torch.Tensor, config: ModelConfig, mesh: Mesh,
                            precision: str = "default", attn: str = "auto"):
    """Explicit-TP decode through the fused kernels (tp.py:426-581), on
    ``fuse_projections(tp=tp)`` W8A8 shards.  Megatron TP forces an
    all-reduce after wo and after w2, so K11's one-launch layer cannot run
    whole; its collective-free spans can, each one launch on the local
    shard:

      attention (K9, or K19) -> K2 -> wo partial (K8) -> all-reduce -> + x
        -> K23 (rms, quant, w13, SiLU x up, quant, w2 partial)
        -> all-reduce -> + x -> K24 (rms, quant, the next layer's qkv)

    Layer 0's qkv comes from the prologue (K3, K8); the last layer's K24
    runs on layer L - 1 again and its result goes unused, as in JAX
    (tp.py:551-553).  The attention is deferred-flush: ``"auto"`` and
    ``"flash"`` take K9 on the card where head_dim % 128 == 0 (the TPU's
    ``dma_ok``), else K19 -- on the CPU the plain K19, as JAX interprets its
    fresh kernel there -- and ``"flash_dma"`` K9 everywhere; one K10 flush
    writes every layer's row after the loop.  The residual stream is f32 (the
    embedding cast before its all-reduce); no 32-row padding, rows are
    independent.  ``precision`` goes unread: the classifier runs at
    "default".  Returns (logits f32 [B, V] on every rank, cache)."""
    del precision
    if attn not in ("auto", "flash", "flash_dma"):
        raise ValueError(f"fused TP attention {attn!r}: want 'auto', 'flash' or 'flash_dma'")
    tp = _check_mesh(config, mesh)
    layers = params.layers
    if not all(isinstance(w, ChannelQuantTensor) for w in (layers.wq, layers.wo, layers.w1,
                                                            layers.w2)):
        raise ValueError("tp_forward_decode_fused requires W8A8 weights in "
                         "fuse_projections(tp=...) layouts")
    local = _local_config(config, tp)
    rows = _data_rows(tokens.shape[0], mesh)
    tok, p = tokens[rows], pos[rows].long()
    B, L = tok.shape[0], layers.rms_att.shape[0]
    pos32 = p.to(torch.int32)
    x = _embed(params, tok, config.vocab_size // tp, mesh, dtype=torch.float32)
    cos, sin = params.rope_cos[p], params.rope_sin[p]
    dma_ok = local.head_dim % 128 == 0 and cache.k.is_cuda
    attend = _decode_attend("flash_dma" if attn == "flash_dma" or dma_ok else "flash", cache)
    qkv = _decode_prologue(layers, x, local)
    fresh = []
    bufs, views = _flush_buffers(cache, B)
    for i in range(L):
        q, k, v = _split_rope(qkv, cos, sin, local)
        fresh.append(_cache_rows(cache, k, v, views[i]))
        att = _attend_fresh(attend, q, cache, pos32, fresh[-1], i)
        attq, satt = quantize_activations(att.reshape(B, local.dim).float())
        x = x + all_reduce(w8a8_matmul_stacked(attq, satt, layers.wo, i), mesh)
        x = x + all_reduce(fused_ffn_stacked(x, layers.w1, layers.w2, layers.rms_ffn, i), mesh)
        qkv = fused_rms_qkv_stacked(x, layers.wq, layers.rms_att, min(i + 1, L - 1))
    _flush(cache, fresh, pos32, bufs)
    logits = matmul_any(rmsnorm(x, params.rms_final), params.wcls, precision="default").float()
    return _gather_logits(logits, mesh), cache


"""The sharded engine's forward: JAX's GSPMD single program, run as an
explicit SPMD program over ``torch.distributed`` ranks.

Port of ``forward_decode`` / ``forward_prefill`` of tpu_llama/models/
llama.py run on ``shard_params`` output under ``jax.jit``: the same
program as the single-device engine's, the params split by
``params_pspecs`` and the cache by ``shard_cache``, with GSPMD placing the
collectives.  Here every rank runs that program on its own shards
(``sharding.shard_params_spmd``, ``sharding.shard_cache``) and places the
collectives itself, so that each rank computes the single-device function
(``parallel.tp`` is another function: it quantizes the attention output and
h2 per shard).  Per layer, on the rank's rows of its ``data`` index:

* the embedding: a masked gather of the rank's vocab rows, all-reduced
  over ``model`` (one row nonzero: exact);
* the column-sharded products (wq, wk, wv, w1, w3, wcls) on the whole,
  replicated activation row: a W8A8 product quantizes the whole row (K2),
  so each of its columns is the single device's bit for bit;
* RoPE, the cache write and the attention on the rank's kv heads, through
  the kernels the single-device engine's ``attn`` picks (K9 or K19 for the
  decode, K6 for the prefill; their fp forms on an fp cache), with the
  key-row split counts the single device takes for the whole batch and all
  heads (``models.llama.split_counts``);
* the row-sharded products (wo, w2; ``row_product``): W8A8 all-gathers the
  input row and quantizes it whole (K2), runs its K-slice into int32 sums
  (K1's int32 form), all-reduces the int32 sums -- exact -- and applies
  K1's epilogue once, with the residual: K1 on the whole K bit for bit.
  Dense and Q8_0 all-reduce f32 partial products (within the order of f32
  sums of the single device); a Q8_0 leaf held whole (a cut that would split
  a quant group) runs whole on the gathered input;
* the logits all-gathered to [B, V] on every rank, over ``model`` and then
  ``data``, so that every rank takes the same decisions.

At model = 1 (pure data parallelism) a rank holds the whole weights, the
fused layouts included, and runs the single-device forward on its rows
(mega2 and the fused prefill body included), its split counts pinned to the
whole batch's.
"""

from __future__ import annotations

import torch

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.device import upload
from tpu_llama_torch.models.llama import (
    LlamaParams,
    _dense_only,
    _last_rows,
    _logits,
    _prefill_layer_at,
    _resolve_decode_attn,
    _resolve_fused,
    _resolve_prefill_attn,
    decode_stack,
    dense_matmul,
    forward_decode,
    forward_prefill,
    forward_prefill_chunked,
    matmul_any,
    split_counts,
)
from tpu_llama_torch.ops.matmul import q8_matmul, w8a8_epilogue, w8a8_matmul_int32
from tpu_llama_torch.ops.quant import ChannelQuantTensor, QuantTensor, quantize_activations
from tpu_llama_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, all_gather, all_reduce
from tpu_llama_torch.parallel.tp import _check_mesh, _data_rows, _embed, _local_config


def _in_features(w) -> int:
    if isinstance(w, (ChannelQuantTensor, QuantTensor)):
        return w.in_features
    return w.shape[-2]


def row_product(mesh: Mesh):
    """The row-sharded product ``residual + a @ W`` over ``model``, for
    ``decode_stack`` / ``_prefill_layer_at``'s ``row_mm``: ``a`` [..., k]
    holds this rank's input columns, W this rank's k input rows (or the
    whole weight, where the shard rule held it whole)."""
    m = mesh.index(MODEL_AXIS)

    def mm(a, w, residual=None, precision="highest"):
        k = a.shape[-1]
        if _in_features(w) != k:  # held whole: the product runs whole on every rank
            return matmul_any(all_gather(a, mesh, MODEL_AXIS, -1), w, residual, precision)
        if isinstance(w, ChannelQuantTensor):
            lead, n = a.shape[:-1], w.out_features
            full = all_gather(a, mesh, MODEL_AXIS, -1)
            xq, sx = quantize_activations(full.reshape(-1, full.shape[-1]))
            acc = all_reduce(w8a8_matmul_int32(xq[:, m * k:(m + 1) * k].contiguous(), w), mesh)
            res = None if residual is None else residual.reshape(-1, n)
            return w8a8_epilogue(acc, sx, w.s, a.dtype, res).reshape(*lead, n)
        if isinstance(w, QuantTensor):
            part = q8_matmul(a, w, out_dtype=torch.float32)
        elif torch.promote_types(a.dtype, w.dtype) == torch.float32:
            part = dense_matmul(a, w, precision)
        else:  # the partials in f32, rounded once after the sum
            part = dense_matmul(a.float(), w.float(), precision)
        out = all_reduce(part, mesh).to(torch.promote_types(a.dtype, _dtype(w)))
        return out if residual is None else residual + out

    return mm


def _dtype(w) -> torch.dtype:
    return torch.float32 if isinstance(w, QuantTensor) else w.dtype


def spmd_forward_decode(params: LlamaParams, cache, tokens: torch.Tensor, pos: torch.Tensor,
                        config: ModelConfig, mesh: Mesh, attn: str = "auto", fused="auto",
                        precision: str = "highest"):
    """One decode step of the sharded engine (``forward_decode`` on sharded
    params): ``params`` this rank's ``shard_params_spmd`` shard, ``cache``
    its local cache [L, B / dp, KVH / tp, S, hd] (updated in place), the
    global tokens and positions [B].  ``attn`` and ``precision`` are
    ``forward_decode``'s; ``fused`` too at model = 1, and above it only
    ``"auto"`` or False (the unfused stack).  Returns (logits f32 [B, V] on
    every rank, cache)."""
    B = tokens.shape[0]
    rows = _data_rows(B, mesh)
    tok, p = tokens[rows].long(), pos[rows].long()
    tp = _check_mesh(config, mesh)
    if tp == 1:  # the fused mode the whole batch takes (B, not the rank's rows)
        fused = _resolve_fused(fused, _resolve_decode_attn(attn, cache), params, config, cache, B)
        logits, cache = forward_decode(params, cache, tok, p, config, attn=attn, fused=fused,
                                       precision=precision, split_rows=B)
        return all_gather(logits, mesh, DATA_AXIS, 0), cache
    if fused not in ("auto", False):
        raise ValueError(f"fused decode {fused!r} above model = 1: the sharded engine decodes "
                         "through the unfused stack")
    attn = _resolve_decode_attn(attn, cache)
    x = _embed(params, tok, config.vocab_size // tp, mesh)
    cos, sin = params.rope_cos[p], params.rope_sin[p]
    x = decode_stack(params.layers, cache, x, p, cos, sin, _local_config(config, tp), attn=attn,
                     precision=precision, splits=split_counts(cache, B, config.n_kv_heads),
                     row_mm=row_product(mesh))
    return _gather(_logits(params, x, precision), mesh), cache


def _gather(logits: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return all_gather(all_gather(logits, mesh, MODEL_AXIS, -1), mesh, DATA_AXIS, 0)


def spmd_prefill_rows(params: LlamaParams, cache, tokens: torch.Tensor,
                      start_pos: torch.Tensor, lengths: torch.Tensor, config: ModelConfig,
                      mesh: Mesh, logits_mode: str = "all", assume_fresh: bool = False,
                      precision: str = "highest", attn: str = "auto"):
    """``forward_prefill`` of the rows this rank holds, on every rank of its
    ``model`` group: tokens [b, T] (the same on each of them) into the local
    cache [L, b, KVH / tp, S, hd] (in place).  ``start_pos``,
    ``logits_mode``, ``assume_fresh``, ``precision`` and ``attn`` as there.
    Returns (logits [b, V] or [b, T, V], gathered over ``model``;
    cache)."""
    tp = _check_mesh(config, mesh)
    if tp == 1:
        return forward_prefill(params, cache, tokens, start_pos, lengths, config, logits_mode,
                               assume_fresh, precision, attn)
    if logits_mode not in ("all", "last"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    _dense_only(cache, "spmd_prefill_rows")
    attn = _resolve_prefill_attn(attn, cache)
    B, T = tokens.shape
    S = cache.seq_len
    dev = tokens.device
    if assume_fresh:  # _forward_prefill_fresh's unfused body
        if T > S:
            raise ValueError(f"{T} prompt rows do not fit a cache of {S}")
        fits, start = True, torch.zeros((B,), dtype=torch.int32, device=dev)
        cos, sin = params.rope_cos[:T], params.rope_sin[:T]
    else:  # forward_prefill's
        host = start_pos.device.type == "cpu"
        fits = host and int(start_pos.max()) + T <= S
        start = (upload(start_pos, dev, torch.int32) if host
                 else start_pos.to(device=dev, dtype=torch.int32))
        pos = (start.long()[:, None] + torch.arange(T, device=dev)[None, :]).clamp(0, S - 1)
        cos, sin = params.rope_cos[pos], params.rope_sin[pos]
    local = _local_config(config, tp)
    mm = row_product(mesh)
    x = _embed(params, tokens, config.vocab_size // tp, mesh)
    for i in range(params.layers.rms_att.shape[0]):
        x = _prefill_layer_at(x, params.layers.layer(i), cache, i, cos, sin, start, local,
                              precision, fits, attn, row_mm=mm)
    if logits_mode == "last":
        x = _last_rows(x, lengths.to(device=dev, dtype=torch.long), T)
    return all_gather(_logits(params, x, precision), mesh, MODEL_AXIS, -1), cache


def spmd_forward_prefill(params: LlamaParams, cache, tokens: torch.Tensor,
                         start_pos: torch.Tensor, lengths: torch.Tensor, config: ModelConfig,
                         mesh: Mesh, logits_mode: str = "all", precision: str = "highest",
                         attn: str = "auto"):
    """Batched causal prefill of the sharded engine (``forward_prefill`` on
    sharded params): the global tokens [B, T], start positions and lengths
    [B]; this rank's local cache updated in place at its rows' positions.
    Returns (logits [B, V] for ``logits_mode="last"``, [B, T, V] for
    ``"all"``, on every rank; cache)."""
    rows = _data_rows(tokens.shape[0], mesh)
    logits, cache = spmd_prefill_rows(params, cache, tokens[rows], start_pos[rows],
                                      lengths[rows], config, mesh, logits_mode,
                                      precision=precision, attn=attn)
    return all_gather(logits, mesh, DATA_AXIS, 0), cache


def spmd_prefill_chunked_rows(params: LlamaParams, cache, tokens: torch.Tensor,
                              lengths: torch.Tensor, config: ModelConfig, mesh: Mesh,
                              chunk: int = 256, precision: str = "highest", attn: str = "auto"):
    """``forward_prefill_chunked`` of the rows this rank holds (from position
    0, ``chunk`` positions at a time): at model = 1 that function itself;
    above it, as its per-chunk branch, ``spmd_prefill_rows`` at start
    i * chunk, each row keeping the logits of the chunk that holds its
    final token.  Returns (next-token logits [b, V] gathered over
    ``model``, cache)."""
    if mesh.size(MODEL_AXIS) == 1:
        return forward_prefill_chunked(params, cache, tokens, lengths, config, chunk=chunk,
                                       precision=precision, attn=attn)
    B, T = tokens.shape
    if chunk <= 0 or T % chunk:
        raise ValueError(f"{T} prompt rows are not a multiple of the chunk {chunk}")
    n = T // chunk
    lengths = lengths.to(device=tokens.device, dtype=torch.long)
    per_chunk = []
    for i in range(n):
        c0 = i * chunk
        logits_c, cache = spmd_prefill_rows(
            params, cache, tokens[:, c0:c0 + chunk], torch.full((B,), c0, dtype=torch.int32),
            (lengths - c0).clamp(1, chunk), config, mesh, "last", precision=precision,
            attn=attn)
        per_chunk.append(logits_c)
    owner = ((lengths - 1) // chunk).clamp(0, n - 1)
    return torch.stack(per_chunk)[owner, torch.arange(B, device=tokens.device)], cache

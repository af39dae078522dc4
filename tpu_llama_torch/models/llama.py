"""Llama-2 forward passes over dense and paged KV caches.

Port of the parts of tpu_llama/models/llama.py that the engine's dense
layouts run: weights dense (``params_from_raw``, ``random_params``), Q8_0
(``quantize_params`` mode "q8_0", K25) or W8A8 (mode "w8a8"); a KV cache
INT8 (``QuantKVCache``) or float32 / bfloat16 (``KVCache``); with the fused
wqkv / w13 layouts of ``fuse_projections`` (what bench.py and the server
run) or without them.  The W8A8 + INT8 paths:

* prefill: ``forward_prefill(assume_fresh=True)`` -> ``_forward_prefill_fresh``
  (llama.py:1378).  Fused layouts run the fused W8A8 body (llama.py:
  1422-1469): K3 rmsnorm+quant, K1 (qkv), K5 rope+split+KV quant into the
  cache, K6 attention, K2 + K1 with the residual (wo), K3, K1 (w13), K4
  silu*up+quant, K1 with the residual (w2).  Unfused layouts run the
  unfused body through ``w8a8_matmul`` (K2 + K1) and K6.
  ``forward_prefill`` at start_pos > 0 (llama.py:2078-2215) runs the same
  bodies with the K/V written at each row's positions and K6 over the
  layer's whole cache; ``forward_prefill_chunked`` (llama.py:1562-1748)
  prefills long prompts in chunks, landing each fused chunk's K/V with K18.
  The attention follows JAX's ``attn`` (``PREFILL_ATTN``): "flash" is K6,
  "xla" ``attention_prefill`` (f32 on the dequantized cache), "auto" the
  one or the other on a CUDA or a CPU cache, as JAX on the TPU or the CPU;
* decode: ``forward_decode(fused=...)`` (llama.py:1101-1203).
  ``fused=False`` -> ``decode_stack``, JAX's unfused decode math on either
  layout: every matmul through K2 + K1, the residual adds in K1's
  epilogue.  ``attn="flash_dma"`` / ``"flash"`` run the deferred-flush
  branch (llama.py:1277-1327): the cache is read-only during the layer
  loop, each layer attends over its rows < pos plus the fresh row (K9 /
  K19), and one K10 call writes every layer's row after the loop.
  ``attn="xla"`` runs the XLA branch (llama.py:1328-1339): per-layer cache
  write, attention over the dequantized cache in plain PyTorch.  ``"auto"``
  is xla on a CPU cache and flash_dma (K9) on a CUDA one
  (``_resolve_decode_attn``).  On fused W8A8 layouts ``fused=True`` ->
  ``fused_decode_stack`` (llama.py:978-1096): per layer the flash
  attention, K2, then K11 (the layer's linear work and the next layer's
  qkv), layer 0's qkv from K3 + K8; ``fused="mega2"`` ->
  ``mega2_decode_stack`` (llama.py:712-805): a prologue (K3, K8, K9, K2),
  then one K12 launch per layer (its linear work and the next layer's
  attention).  Opt-in only, as in JAX: ``fused="mega3"`` ->
  ``mega3_decode_stack`` (llama.py:826-905): mega2's prologue, then one K26
  launch per pair of layers; ``fused="mega"`` -> ``fused_decode_stack(
  mega=True)``: per layer RoPE and quantize_kv, then one K27 launch (the
  layer's attention, its quant, then K11's phases).  All keep the deferred
  K10 flush.  ``fused="auto"`` is False on a CPU cache, mega2 or the
  two-launch decode on a CUDA one (``_resolve_fused``).

Dense and Q8_0 weights, and fp caches, take JAX's other branches:

* every matmul is ``matmul_any`` (llama.py:518): dense weights through
  ``torch.matmul`` at the caller's ``precision`` (the JAX package leaves
  them to XLA), Q8_0 through K25, W8A8 through K2 + K1;
* prefill at start 0 and at start > 0 runs the unfused body (``layer_step``,
  llama.py:1510-1518, :2153-2204) -- so do W8A8 fused layouts over an fp
  cache at start > 0 -- with the fp K/V cast to the cache's dtype before
  both the write and K6's fp form (llama.py:1498-1508); at start 0 fused
  W8A8 layouts over an fp cache run the fused body's K3 / K1 / K4 with the
  fp attention instead of K5 (llama.py:1433-1440);
* chunked prefill over an fp cache, or of dense / Q8_0 weights, runs
  ``forward_prefill`` per chunk (llama.py:1562-1596): K18 is INT8-only;
* decode: ``decode_stack``'s fp branch (llama.py:1308-1327: the fresh rows
  cast to the cache's dtype, the fp forms of K9 / K19, one fp K10 flush)
  and its xla branch; on W8A8 fused layouts ``fused=True`` runs
  ``fused_decode_stack``'s fp branch (llama.py:1062-1066, :1091-1094).
  mega2 (K12) takes a dense INT8 cache only; ``"auto"`` resolves to False
  on dense and Q8_0 weights (``_fused_path_ok``).

``precision`` ("default", "high", "highest"; llama.py:1113) is each entry
point's argument, as in JAX, and reaches only dense float32 products: on
the card "highest" runs them in full f32, "default" and "high" in TF32
(what XLA does with them on a GPU); the CPU has full f32 only.  No
process-wide setting is left changed.

JAX's functional cache updates become IN-PLACE writes into the cache
tensors: ``forward_prefill`` and ``forward_decode`` mutate the cache they
are given and return it.  JAX's ``lax.scan`` over stacked layers becomes a
Python loop over per-layer views.  Weights stay stacked ``[L, ...]``;
quantized matmul weights are K-major (``q [L, out, in]``).

A paged INT8 cache (``PagedKVCache``: shared page pools and a per-slot
page table, llama.py:147-209) is decoded by ``decode_stack`` and
``fused_decode_stack`` through K13 (K20 for ``attn="flash"``) and one K14
flush per step (llama.py:1237-1276, :1009-1085); mega2 never takes it.  It
is filled by the engine: a compact prefill, then K15, or for a large
admission ``forward_prefill_paged_chunked`` (llama.py:1772-2011): chunks
prefilled straight into the pool, K16 attending over the past pages plus
the chunk's fresh rows and K17 landing them.

Routes the port does not carry yet raise ``NotImplementedError`` naming
their ROADMAP item: W4A8 weights.  ``fuse_projections(tp > 1)`` gives the
tensor-parallel column order that ``parallel.tp`` takes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.device import resolve_device, upload
from tpu_llama_torch.io.checkpoint import RawWeights
from tpu_llama_torch.ops.attention import (
    _dma_block,
    _norm_block,
    attention_prefill,
    decode_splits,
    flash_decode_attention,
    flash_decode_attention_dma,
    flash_decode_attention_fresh,
    flash_prefill_attention,
    kv_cache_flush_rows,
    kv_cache_write_chunk,
    kv_pool_flush_rows,
    kv_pool_write_chunk,
    paged_flash_decode_attention_dma,
    paged_flash_decode_attention_fresh,
    norm_splits,
    paged_flash_prefill_attention,
    quantize_kv,
)
from tpu_llama_torch.ops.fused_layer import MAX_ROWS, fused_layer_linear, w8a8_matmul_stacked
from tpu_llama_torch.ops.fused_step import fused_step_layer
from tpu_llama_torch.ops.fused_step2 import fused_splits, fused_step2_layer
from tpu_llama_torch.ops.fused_step3 import fused_step3_pair
from tpu_llama_torch.ops.matmul import q8_matmul, w8a8_matmul, w8a8_matmul_prequant
from tpu_llama_torch.ops.quant import (
    ChannelQuantTensor,
    QuantTensor,
    kernel_alignment,
    pick_group_size,
    quantize_activations,
    quantize_channel,
    quantize_q8,
    rmsnorm_quantize,
    rope_f32,
    rope_split_quantize,
    silu_mul_quantize,
)

_NEG_INF = -1e30


_QUANTIZED = (ChannelQuantTensor, QuantTensor)


def _take(w, i: int):
    return w.layer(i) if isinstance(w, _QUANTIZED) else w[i]


@dataclasses.dataclass
class LayerParams:
    """Per-layer weights stacked on axis 0 over layers.  Matmul weights are
    dense [L, in, out] tensors in the JAX layout, or after
    ``quantize_params`` ``QuantTensor``s (Q8_0) or ``ChannelQuantTensor``s
    (W8A8), both K-major (q [L, out, in]).  In the fused layouts of
    ``fuse_projections`` wq is D -> D + 2 KVD ([q|k|v]), w1 is D -> 2H
    ([gate|up]), and wk, wv and w3 are dense [L, 1, 1] stubs."""

    rms_att: torch.Tensor  # [L, D]
    wq: ChannelQuantTensor  # D -> D (fused: D -> D + 2 KVD)
    wk: ChannelQuantTensor  # D -> KVD (fused: stub)
    wv: ChannelQuantTensor  # D -> KVD (fused: stub)
    wo: ChannelQuantTensor  # D -> D
    rms_ffn: torch.Tensor  # [L, D]
    w1: ChannelQuantTensor  # D -> H (gate; fused: D -> 2H)
    w2: ChannelQuantTensor  # H -> D (down)
    w3: ChannelQuantTensor  # D -> H (up; fused: stub)

    def layer(self, i: int) -> "LayerParams":
        """Layer ``i`` as views of the stacked weights."""
        return LayerParams(**{f.name: _take(getattr(self, f.name), i)
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass
class LlamaParams:
    tok_emb: torch.Tensor  # [V, D]
    layers: LayerParams
    rms_final: torch.Tensor  # [D]
    wcls: ChannelQuantTensor  # D -> V
    rope_cos: torch.Tensor  # [S, hd/2] f32
    rope_sin: torch.Tensor  # [S, hd/2] f32


@dataclasses.dataclass
class QuantKVCache:
    """INT8 KV cache: values [L, B, KVH, S, hd] + per-(token, head) f32
    scales [L, B, KVH, S] (symmetric absmax over hd).  Updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch: int, seq_len: int | None = None,
               device=None) -> "QuantKVCache":
        dev = resolve_device(device)
        S = seq_len or config.seq_len
        shape = (config.n_layers, batch, config.n_kv_heads, S, config.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        )

    @property
    def seq_len(self) -> int:
        return self.k.shape[3]

    @property
    def arrays(self) -> tuple[str, ...]:
        """The names of the cache's tensors."""
        return ("k", "v", "ks", "vs")

    def zero_(self) -> None:
        for t in (self.k, self.v, self.ks, self.vs):
            t.zero_()


@dataclasses.dataclass
class KVCache:
    """Dense fp KV cache (llama.py:82): values [L, B, KVH, S, hd] in float32
    or bfloat16, head-major, no scales.  Updated in place."""

    k: torch.Tensor
    v: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch: int, dtype=torch.float32,
               seq_len: int | None = None, device=None) -> "KVCache":
        dev = resolve_device(device)
        S = seq_len or config.seq_len
        shape = (config.n_layers, batch, config.n_kv_heads, S, config.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))

    @property
    def seq_len(self) -> int:
        return self.k.shape[3]

    # an fp cache has no scale arrays: the kernels' wrappers take None
    ks = None
    vs = None

    @property
    def arrays(self) -> tuple[str, ...]:
        """The names of the cache's tensors."""
        return ("k", "v")

    def zero_(self) -> None:
        self.k.zero_()
        self.v.zero_()


@dataclasses.dataclass
class PagedKVCache:
    """INT8 KV in a shared page pool plus a per-slot page table (llama.py:
    147-195): values k, v int8 [L, P, KVH, ps, hd], scales ks, vs f32
    [L, P, KVH, ps], and ``page_table`` int32 [B, MP] mapping each slot's
    context block j (positions [j * ps, (j + 1) * ps)) to a pool page.
    Pages are handed out by the host's ``runtime.paged.PagePool``; page 0 is
    the trash page that parked slots and positions past a reservation land
    in.  Memory scales with the pages in use, and decode reads scale with
    each slot's context.  Not a ``QuantKVCache``: the dense kernels (K7, K9,
    K10, K12, K18, K19) take [L, B, KVH, S, hd] and must never see a pool.
    Updated in place."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor
    page_table: torch.Tensor

    @classmethod
    def create(cls, config: ModelConfig, batch: int, num_pages: int, page_size: int = 512,
               seq_len: int | None = None, device=None) -> "PagedKVCache":
        dev = resolve_device(device)
        S = seq_len or config.seq_len
        mp = -(-S // page_size)
        shape = (config.n_layers, num_pages, config.n_kv_heads, page_size, config.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            page_table=torch.zeros((batch, mp), dtype=torch.int32, device=dev),
        )

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def seq_len(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def arrays(self) -> tuple[str, ...]:
        """The names of the pool tensors (the page table is not one)."""
        return ("k", "v", "ks", "vs")

    def zero_(self) -> None:
        for t in (self.k, self.v, self.ks, self.vs, self.page_table):
            t.zero_()


_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def kv_torch_dtype(kv_dtype) -> torch.dtype:
    """'float32' | 'bfloat16' | 'int8' (or the torch dtype) -> the dtype."""
    dt = _KV_DTYPES.get(kv_dtype, kv_dtype)
    if dt not in _KV_DTYPES.values():
        raise ValueError(f"kv_dtype {kv_dtype!r}: want one of {sorted(_KV_DTYPES)}")
    return dt


def make_kv_cache(config: ModelConfig, batch: int, kv_dtype="float32",
                  seq_len: int | None = None, paged: bool = False, num_pages: int | None = None,
                  page_size: int = 512, device=None):
    """kv_dtype 'float32' (the default, as in JAX), 'bfloat16' or 'int8'
    (llama.py:199): a ``KVCache`` or a ``QuantKVCache``; with ``paged`` a
    ``PagedKVCache`` of ``num_pages`` pages (default: the dense equivalent,
    batch * ceil(S / page_size)) of ``page_size`` rows, which requires
    int8."""
    dt = kv_torch_dtype(kv_dtype)
    if paged:
        if dt != torch.int8:
            raise ValueError("paged KV cache requires kv_dtype='int8'")
        S = seq_len or config.seq_len
        n = num_pages or batch * (-(-S // page_size))
        return PagedKVCache.create(config, batch, n, page_size=page_size, seq_len=S,
                                   device=device)
    if dt == torch.int8:
        return QuantKVCache.create(config, batch, seq_len=seq_len, device=device)
    return KVCache.create(config, batch, dtype=dt, seq_len=seq_len, device=device)


def _rope_tables(config: ModelConfig, device):
    hd2 = config.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd2, dtype=np.float64) * 2 / config.head_dim))
    angles = np.arange(config.seq_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    return (torch.tensor(np.cos(angles), dtype=torch.float32, device=device),
            torch.tensor(np.sin(angles), dtype=torch.float32, device=device))


def params_from_raw(raw: RawWeights, dtype=torch.float32, device=None) -> LlamaParams:
    """A checkpoint's (out, in) f32 tensors -> the stacked (in, out) layout
    on ``device`` (None = the card) in ``dtype`` (llama.py:215); the RoPE
    tables stay f32.  One host copy per tensor (the transpose), then one
    upload, so a memory-mapped checkpoint is read once."""
    dev = resolve_device(device)

    def t(x, axes=None):
        a = np.asarray(x)
        a = np.require(a if axes is None else a.transpose(axes), requirements=["C", "W"])
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    def tr(x):
        return t(x, (0, 2, 1))

    layers = LayerParams(rms_att=t(raw.rms_att), wq=tr(raw.wq), wk=tr(raw.wk), wv=tr(raw.wv),
                         wo=tr(raw.wo), rms_ffn=t(raw.rms_ffn), w1=tr(raw.w1), w2=tr(raw.w2),
                         w3=tr(raw.w3))

    def rope(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return LlamaParams(tok_emb=t(raw.token_embedding), layers=layers, rms_final=t(raw.rms_final),
                       wcls=t(raw.wcls, (1, 0)), rope_cos=rope(raw.freq_cis_real),
                       rope_sin=rope(raw.freq_cis_imag))


def random_params(config: ModelConfig, dtype=torch.bfloat16, seed: int = 0,
                  scale: float = 0.02, device=None) -> LlamaParams:
    """Random dense parameters generated on the device in ``dtype``
    (llama.py:248) from one ``torch.Generator`` seeded with ``seed``: normal
    * ``scale`` matmul weights and embeddings, unit norms, llama2.c's RoPE
    tables.  The draws differ from ``jax.random``'s; the shapes and dtypes
    are the same.  A 7B model in f32 is 27 GB: it is made layer by layer
    into its stacks, so no temporary is larger than one layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = config
    L, D, H, KVD, V = c.n_layers, c.dim, c.hidden_dim, c.kv_dim, c.vocab_size

    def t(*shape):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in (out if len(shape) == 3 else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev) * scale)
        return out

    cos, sin = _rope_tables(c, dev)
    return LlamaParams(
        tok_emb=t(V, D),
        layers=LayerParams(rms_att=torch.ones((L, D), dtype=dtype, device=dev),
                           wq=t(L, D, D), wk=t(L, D, KVD), wv=t(L, D, KVD), wo=t(L, D, D),
                           rms_ffn=torch.ones((L, D), dtype=dtype, device=dev),
                           w1=t(L, D, H), w2=t(L, H, D), w3=t(L, D, H)),
        rms_final=torch.ones((D,), dtype=dtype, device=dev),
        wcls=t(D, V),
        rope_cos=cos,
        rope_sin=sin,
    )


def extend_rope(params: LlamaParams, new_len: int) -> LlamaParams:
    """RoPE tables extended past the checkpoint's seq_len with llama2.c's
    formula, theta = 10000^(-2i/hd) (llama.py:361); the checkpoint's rows
    stay as they are."""
    cur, hd2 = params.rope_cos.shape
    if new_len <= cur:
        return params
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd2, dtype=np.float64) / hd2))
    angles = np.arange(cur, new_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    dev = params.rope_cos.device
    return dataclasses.replace(
        params,
        rope_cos=torch.cat([params.rope_cos,
                            torch.tensor(np.cos(angles), dtype=torch.float32, device=dev)]),
        rope_sin=torch.cat([params.rope_sin,
                            torch.tensor(np.sin(angles), dtype=torch.float32, device=dev)]))


def random_quant_params(config: ModelConfig, mode: str = "w8a8", seed: int = 0,
                        norm_dtype=torch.bfloat16, fuse: bool = False,
                        device=None) -> LlamaParams:
    """Random parameters generated directly in INT8 on the device
    (llama.py:288), from one ``torch.Generator`` seeded with ``seed``: mode
    "w8a8" (per-channel, scales 2e-4) or "q8_0" (group-wise with
    ``pick_group_size``'s group, both dims padded as ``quantize_q8`` pads
    them, scales 2e-4).  The draws differ from ``jax.random``'s; the shapes,
    scales and dtypes are the same.  ``fuse=True`` draws the fused wqkv /
    w13 layouts of ``fuse_projections`` with [L, 1, 1] stubs for wk, wv and
    w3 (llama.py:337-343)."""
    if mode not in ("w8a8", "q8_0"):
        raise NotImplementedError(f"mode {mode!r}: w8a8 and q8_0 are ported (W4A8 is ROADMAP "
                                  "queue 1 item 10)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = config
    L, D, H, KVD, V = c.n_layers, c.dim, c.hidden_dim, c.kv_dim, c.vocab_size

    def qt(in_f, out_f, lead=()):
        if mode == "q8_0":  # llama.py:323-331
            g = pick_group_size(in_f)
            align = kernel_alignment(g)
            pin, pout = -(-in_f // align) * align, -(-out_f // 128) * 128
            q = torch.randint(-127, 128, (*lead, pout, pin), generator=gen, dtype=torch.int8,
                              device=dev)
            return QuantTensor(q=q, s=torch.full((*lead, pout, pin // g), 2e-4,
                                                 dtype=torch.float32, device=dev),
                               logical_in=in_f, logical_out=out_f)
        q = torch.randint(-127, 128, (*lead, out_f, in_f), generator=gen,
                          dtype=torch.int8, device=dev)
        return ChannelQuantTensor(
            q=q, s=torch.full((*lead, out_f), 2e-4, dtype=torch.float32, device=dev))

    cos, sin = _rope_tables(c, dev)
    tok_emb = torch.randn((V, D), generator=gen, dtype=norm_dtype, device=dev) * 0.02
    if fuse:
        stub = torch.zeros((L, 1, 1), dtype=norm_dtype, device=dev)
        wq, wk, wv, wo = qt(D, D + 2 * KVD, (L,)), stub, stub, qt(D, D, (L,))
        w1, w2, w3 = qt(D, 2 * H, (L,)), qt(H, D, (L,)), stub
    else:
        wq, wk, wv, wo = qt(D, D, (L,)), qt(D, KVD, (L,)), qt(D, KVD, (L,)), qt(D, D, (L,))
        w1, w2, w3 = qt(D, H, (L,)), qt(H, D, (L,)), qt(D, H, (L,))
    return LlamaParams(
        tok_emb=tok_emb,
        layers=LayerParams(
            rms_att=torch.ones((L, D), dtype=norm_dtype, device=dev),
            wq=wq, wk=wk, wv=wv, wo=wo,
            rms_ffn=torch.ones((L, D), dtype=norm_dtype, device=dev),
            w1=w1, w2=w2, w3=w3,
        ),
        rms_final=torch.ones((D,), dtype=norm_dtype, device=dev),
        wcls=qt(D, V),
        rope_cos=cos,
        rope_sin=sin,
    )


def quantize_params(params: LlamaParams, group_size: int | None = None,
                    quantize_wcls: bool = True, mode: str = "q8_0") -> LlamaParams:
    """INT8 conversion of the seven matmul families and (with
    ``quantize_wcls``) the classifier (llama.py:383): dense [.., in, out]
    weights -> mode "q8_0" (the default, as in JAX: group-wise weight-only,
    ``group_size`` or ``pick_group_size``'s, K25) or "w8a8" (per-channel
    weights with per-row activation quant, K1).  Norm weights, embeddings,
    RoPE tables and the [L, 1, 1] stubs of ``fuse_projections`` (never
    multiplied, llama.py:415-422) stay floating point."""
    if mode == "w8a8":
        qz = quantize_channel
    elif mode == "q8_0":
        def qz(w):
            return quantize_q8(w, group_size)
    elif mode == "w4a8":
        raise NotImplementedError("mode 'w4a8': ROADMAP queue 1 item 10")
    else:
        raise ValueError(f"unknown quant mode {mode!r}")
    lp = params.layers

    def q(w):
        return w if w.dim() == 3 and w.shape[-2:] == (1, 1) else qz(w)

    return LlamaParams(
        tok_emb=params.tok_emb,
        layers=LayerParams(rms_att=lp.rms_att, wq=q(lp.wq), wk=q(lp.wk), wv=q(lp.wv),
                           wo=q(lp.wo), rms_ffn=lp.rms_ffn, w1=q(lp.w1), w2=q(lp.w2),
                           w3=q(lp.w3)),
        rms_final=params.rms_final,
        wcls=q(params.wcls) if quantize_wcls else params.wcls,
        rope_cos=params.rope_cos,
        rope_sin=params.rope_sin,
    )


def fuse_projections(params: LlamaParams, tp: int = 1) -> LlamaParams:
    """Fuse each layer's [wq|wk|wv] into one wqkv and [w1|w3] into one w13
    (llama.py:440), on dense [L, in, out] weights: apply before
    ``quantize_params``.  wk, wv and w3 become [L, 1, 1] stubs; every
    forward path finds the fused layouts by output width.  ``tp > 1`` puts
    the fused columns in ``tp_interleave``'s order (llama.py:464-472).
    Such weights are valid only for ``parallel.tp``'s paths: a
    single-device [:D] split would mix shards."""
    lp = params.layers
    if isinstance(lp.wq, _QUANTIZED):
        raise ValueError("fuse_projections must run before quantization")
    stub = torch.zeros((lp.rms_att.shape[0], 1, 1), dtype=lp.wq.dtype, device=lp.wq.device)
    fused = dataclasses.replace(params, layers=dataclasses.replace(
        lp, wq=torch.cat([lp.wq, lp.wk, lp.wv], dim=-1), wk=stub, wv=stub,
        w1=torch.cat([lp.w1, lp.w3], dim=-1), w3=stub))
    return _interleave_columns(fused, (lp.wq.shape[-1], lp.wk.shape[-1], lp.wv.shape[-1]),
                               (lp.w1.shape[-1], lp.w3.shape[-1]), tp)


def unfuse_projections(params: LlamaParams, config: ModelConfig) -> LlamaParams:
    """The same weights in the unfused layouts: ``fuse_projections``' (tp =
    1) wqkv split back into wq, wk, wv and w13 into w1, w3, as views of
    their output columns (dense [L, in, out], or W8A8 rows of q [L, out,
    in] and of s).  The unfused prefill body and decode stack run on them,
    and the sharded engine splits them over ``model``."""
    lp = params.layers
    D, KVD, H = config.dim, config.kv_dim, config.hidden_dim

    def cols(w, a, b):
        if isinstance(w, ChannelQuantTensor):
            return ChannelQuantTensor(q=w.q[..., a:b, :], s=w.s[..., a:b])
        if isinstance(w, QuantTensor):
            raise ValueError("unfuse_projections takes dense or W8A8 weights")
        return w[..., a:b]

    if _out_features(lp.wq) != D + 2 * KVD or _out_features(lp.w1) != 2 * H:
        raise ValueError("unfuse_projections takes fuse_projections' layouts")
    return dataclasses.replace(params, layers=dataclasses.replace(
        lp, wq=cols(lp.wq, 0, D), wk=cols(lp.wq, D, D + KVD), wv=cols(lp.wq, D + KVD, D + 2 * KVD),
        w1=cols(lp.w1, 0, H), w3=cols(lp.w1, H, 2 * H)))


def tp_interleave(params: LlamaParams, config: ModelConfig, tp: int) -> LlamaParams:
    """Fused tp = 1 layouts ([q|k|v], [w1|w3]; dense, or W8A8 as
    ``random_quant_params(fuse=True)`` draws them) in the shard-interleaved
    column order of the explicit tensor-parallel path: columns grouped per
    model shard as [q_i | k_i | v_i] and [w1_i | w3_i], so that splitting
    the fused axis over ``tp`` ranks hands each its own local fused layout.
    A per-channel quant sees each column alone, so interleaving W8A8
    weights equals quantizing interleaved ones."""
    D, KVD, H = config.dim, config.kv_dim, config.hidden_dim
    return _interleave_columns(params, (D, KVD, KVD), (H, H), tp)


def _interleave_columns(params: LlamaParams, qkv_widths, ffn_widths, tp: int) -> LlamaParams:
    """``tp_interleave`` on the fused wqkv and w13 made of parts of these
    widths."""
    if tp == 1:
        return params
    for w in qkv_widths + ffn_widths:
        if w % tp:
            raise ValueError(f"a width of {w} does not split over tp={tp}")

    def order(widths):
        starts = [sum(widths[:j]) for j in range(len(widths))]
        return torch.cat([torch.arange(s + i * (w // tp), s + (i + 1) * (w // tp))
                          for i in range(tp) for s, w in zip(starts, widths)])

    def permute(w, idx):
        if isinstance(w, ChannelQuantTensor):
            idx = idx.to(w.q.device)
            return ChannelQuantTensor(q=w.q.index_select(-2, idx), s=w.s.index_select(-1, idx))
        if isinstance(w, QuantTensor):
            raise TypeError("tp_interleave takes dense or per-channel W8A8 weights")
        return w.index_select(-1, idx.to(w.device))

    lp = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(
        lp, wq=permute(lp.wq, order(qkv_widths)), w1=permute(lp.w1, order(ffn_widths))))


PRECISIONS = ("default", "high", "highest")


@contextlib.contextmanager
def _f32_products(precision: str):
    """Dense float32 products on the card at ``precision`` for the calls
    inside: TF32 for "default" and "high", full f32 for "highest"; the
    caller's setting is restored on the way out."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: want one of {PRECISIONS}")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def dense_matmul(a: torch.Tensor, w: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """``a @ w`` for a dense weight in the dtype both promote to, as
    ``jnp.dot(a, w, precision=...)``: ``precision`` matters only to float32
    products on the card (see ``_f32_products``)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    a, w = a.to(dt), w.to(dt)
    if dt != torch.float32 or a.device.type != "cuda":
        return a @ w
    with _f32_products(precision):
        return a @ w


def matmul_any(a: torch.Tensor, w, residual=None, precision: str = "highest") -> torch.Tensor:
    """``a @ W`` dispatching on the weight type (llama.py:518): Q8_0
    through K25 and dense weights through ``dense_matmul`` (both in a's
    dtype, then ``residual +``), per-channel W8A8 through K2 + K1 with
    ``residual`` in K1's epilogue (the matmul term rounded to a's dtype,
    then added: the numerics of ``residual + a @ W``)."""
    if isinstance(w, ChannelQuantTensor):
        return w8a8_matmul(a, w, out_dtype=a.dtype, residual=residual)
    if isinstance(w, QuantTensor):
        out = q8_matmul(a, w, out_dtype=a.dtype)
    else:
        out = dense_matmul(a, w, precision)
    return out if residual is None else residual + out


def _out_features(w) -> int:
    return w.out_features if isinstance(w, _QUANTIZED) else w.shape[-1]


def _project_qkv(h, lp: LayerParams, config: ModelConfig, precision: str = "highest"):
    """q/k/v projections, transparently handling a fused wqkv weight."""
    D, KVD = config.dim, config.kv_dim
    if _out_features(lp.wq) == D + 2 * KVD:
        qkv = matmul_any(h, lp.wq, precision=precision)
        return qkv[..., :D], qkv[..., D:D + KVD], qkv[..., D + KVD:]
    return tuple(matmul_any(h, w, precision=precision) for w in (lp.wq, lp.wk, lp.wv))


def _fused_layouts(layers: LayerParams, config: ModelConfig) -> bool:
    """Whether the weights are in ``fuse_projections``' layouts."""
    return (_out_features(layers.wq) == config.dim + 2 * config.kv_dim
            and _out_features(layers.w1) == 2 * config.hidden_dim)


def _fused_w8a8(layers: LayerParams, config: ModelConfig) -> bool:
    """W8A8 weights in the fused layouts: what the fused prefill body takes
    (``_prefill_w8a8_fast_ok``, llama.py:1344, without its TPU gates)."""
    return (_fused_layouts(layers, config)
            and all(isinstance(w, ChannelQuantTensor)
                    for w in (layers.wq, layers.wo, layers.w1, layers.w2)))


def _project_gate_up(h, lp: LayerParams, config: ModelConfig, precision: str = "highest"):
    H = config.hidden_dim
    if _out_features(lp.w1) == 2 * H:
        gu = matmul_any(h, lp.w1, precision=precision)
        return gu[..., :H], gu[..., H:]
    return matmul_any(h, lp.w1, precision=precision), matmul_any(h, lp.w3, precision=precision)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """w * x / sqrt(1e-5 + mean(x^2)) with eps inside the rsqrt and the cast
    to x's dtype before the weight multiply (llama.py:532)."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(1e-5 + ms)).to(x.dtype) * weight


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved (even, odd) pairs of every head in f32, then cast
    back (llama.py:540).  x [..., n_heads, hd]; cos/sin broadcastable to
    [..., hd/2]."""
    return rope_f32(x, cos, sin).to(x.dtype)


def _attention_decode(q, k_cache, v_cache, pos, config: ModelConfig):
    """q [B, NH, hd] over f32 k/v [B, KVH, S, hd]; key s attends iff
    s <= pos[b] (llama.py:558)."""
    B, S = k_cache.shape[0], k_cache.shape[2]
    hd, kvh, g = config.head_dim, config.n_kv_heads, config.group_size
    qg = q.reshape(B, kvh, g, hd).float()
    scores = torch.einsum("bkgh,bksh->bkgs", qg, k_cache) / math.sqrt(hd)
    mask = torch.arange(S, device=q.device)[None, None, None, :] <= pos[:, None, None, None]
    att = torch.softmax(scores.masked_fill(~mask, _NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", att, v_cache)
    return out.reshape(B, config.dim).to(q.dtype)


PREFILL_ATTN = ("auto", "flash", "xla")


def _resolve_prefill_attn(attn: str, cache) -> str:
    """The prefill's attention, resolved as the JAX package resolves it
    (llama.py:1396-1397, :2079-2083) and ``parallel.tp`` does: ``"auto"`` is
    ``"flash"`` (K6) on a CUDA cache, as on the TPU, and ``"xla"``
    (``attention_prefill``) on a CPU one.  An explicit ``"flash"`` on the
    CPU runs K6's plain version, the card's function."""
    if attn not in PREFILL_ATTN:
        raise ValueError(f"prefill attention {attn!r}: want one of {PREFILL_ATTN}")
    if attn == "auto":
        return "flash" if cache.k.device.type == "cuda" else "xla"
    return attn


def prefill_attention(attn: str):
    """The prefill attention a resolved ``attn`` runs: K6
    (``flash_prefill_attention``) for ``"flash"``, ``attention_prefill``
    for ``"xla"``; both take (q, k, v, start, k_scale, v_scale,
    out_dtype=)."""
    return flash_prefill_attention if attn == "flash" else attention_prefill


def _cache_rows(cache, k, v, out=None) -> dict:
    """A step's (or a block's) K/V as the cache stores them, by array name:
    quantized with their scales for an INT8 cache, cast to the cache's
    dtype for an fp one (llama.py:1301-1313).  ``out``: one layer's views
    of the step's flush buffers (``_flush_buffers``), by array name, which
    the quant or the cast writes into and which are returned."""
    if isinstance(cache, (QuantKVCache, PagedKVCache)):
        kq, ks = quantize_kv(k, out=out and (out["k"], out["ks"]))
        vq, vs = quantize_kv(v, out=out and (out["v"], out["vs"]))
        return {"k": kq, "v": vq, "ks": ks, "vs": vs}
    if out:
        return {"k": out["k"].copy_(k), "v": out["v"].copy_(v)}
    return {"k": k.to(cache.k.dtype), "v": v.to(cache.v.dtype)}


def _write_decode(cache, layer: int, k, v, pos, config: ModelConfig) -> None:
    """Write one decoded token's K/V [B, KVH, hd] (quantized, or cast to an
    fp cache's dtype) IN PLACE at position pos[b] of layer ``layer``
    (llama.py:611)."""
    B = k.shape[0]
    b_ix = torch.arange(B, device=k.device)[:, None]
    h_ix = torch.arange(config.n_kv_heads, device=k.device)[None, :]
    p_ix = pos[:, None]
    for n, rows in _cache_rows(cache, k, v).items():
        getattr(cache, n)[layer][b_ix, h_ix, p_ix] = rows


def _attend_decode(cache, layer: int, q, pos, config: ModelConfig, attn: str = "xla"):
    """Write-then-attend decode attention of layer ``layer`` (llama.py:
    636-654), the step's row already written: an INT8 cache with ``attn``
    other than ``"xla"``, or an fp cache with ``"flash"``, goes through K21
    (its fp form for an fp cache); otherwise the xla branch: the layer's
    cache dequantized (INT8) or upcast (fp), then plain attention."""
    B = q.shape[0]
    int8 = isinstance(cache, QuantKVCache)
    if (int8 and attn != "xla") or attn == "flash":
        qg = q.reshape(B, config.n_kv_heads, config.group_size, config.head_dim)
        out = flash_decode_attention(qg, cache.k, cache.v, pos, cache.ks, cache.vs, layer=layer)
        return out.reshape(B, config.dim).to(q.dtype)
    kf, vf = cache.k[layer].float(), cache.v[layer].float()
    if int8:
        kf, vf = kf * cache.ks[layer][..., None], vf * cache.vs[layer][..., None]
    return _attention_decode(q, kf, vf, pos, config)


DECODE_ATTN = ("auto", "flash", "flash_dma", "xla")


def _resolve_decode_attn(attn: str, cache) -> str:
    """``forward_decode``'s attention policy (the structure of llama.py:
    1115-1130).  ``"auto"`` is ``"xla"`` on a CPU cache, as the JAX package
    on the CPU, and K9 (``"flash_dma"``) on a CUDA cache at every batch:
    on an H100, K9 was never slower than K19 (``"flash"``) on the device at
    batch 1 or 8 (the A/B in PERF.md), so the TPU's batch-1 exception is
    not carried, nor its ``head_dim % 128`` gate (the CUDA kernels take any
    head_dim up to 128 whose cache rows are a multiple of 4 bytes).  The
    same on INT8 and fp caches.  On a paged cache ``"auto"`` is K13
    (``"flash_dma"``) on the card and, on the CPU, JAX's rule (llama.py:
    1125-1126): ``"flash_dma"`` where head_dim % 128 == 0, else ``"flash"``
    (K20), so that CPU streams equal the JAX engine's at small head dims.
    A paged cache has no ``"xla"`` path: it decodes through K13 there, as
    in JAX (``_decode_attend``)."""
    if attn not in DECODE_ATTN:
        raise ValueError(f"decode attention {attn!r}: want one of {DECODE_ATTN}")
    if attn != "auto":
        return attn
    if isinstance(cache, PagedKVCache):
        if cache.k.device.type == "cuda" or cache.k.shape[-1] % 128 == 0:
            return "flash_dma"
        return "flash"
    return "flash_dma" if cache.k.device.type == "cuda" else "xla"


def _decode_attend(attn: str, cache):
    """The deferred-flush decode attention that ``attn`` runs on ``cache``:
    K9 for ``"flash_dma"`` and K19 for ``"flash"`` on a dense cache; on a
    paged one K20 for ``"flash"`` and K13 for anything else (llama.py:
    1241-1247)."""
    if isinstance(cache, PagedKVCache):
        return paged_flash_decode_attention_fresh if attn == "flash" else \
            paged_flash_decode_attention_dma
    return flash_decode_attention_dma if attn == "flash_dma" else flash_decode_attention_fresh


def _attend_fresh(attend, q, cache, pos32, fresh: dict, layer: int, splits=None):
    """One deferred-flush attention call (K9 or K19, INT8 or fp form; K13
    or K20 on a paged cache) of ``layer`` over the cache's rows < pos plus
    the step's ``fresh`` rows (``_cache_rows``); ``splits`` the key-row
    splits of a dense cache's kernel (None: its own rule)."""
    if isinstance(cache, PagedKVCache):
        return attend(q, cache.k, cache.v, cache.ks, cache.vs, cache.page_table, pos32,
                      fresh["k"], fresh["v"], fresh["ks"], fresh["vs"], layer=layer)
    return attend(q, cache.k, cache.v, pos32, fresh["k"], fresh["v"], cache.ks, cache.vs,
                  fresh.get("ks"), fresh.get("vs"), layer=layer, splits=splits)


def split_counts(cache, B: int, KVH: int) -> dict:
    """The key-row splits each dense-cache decode attention takes for B
    slots of KVH kv heads over ``cache``'s rows, by its own rule read at
    these counts: ``"flash_dma"`` K9 (``decode_splits``), ``"flash"`` K19
    (``norm_splits``), ``"fused"`` the cells of K12, K26 and K27
    (``fused_splits``).  The rules read B and KVH, so a rank that holds a
    share of the slots or the heads passes the counts the single-device
    engine takes for the whole batch: the split merge order, and with it
    every rounding after, stays the single device's."""
    S, item = cache.k.shape[3], cache.k.element_size()
    return {"flash_dma": decode_splits(B, KVH, _dma_block(S, None, item), S),
            "flash": norm_splits(B, KVH, _norm_block(S, item), S),
            "fused": fused_splits(B, KVH, _dma_block(S, None), S)}


def _flush_buffers(cache, B: int) -> tuple:
    """The step's flush buffers of a deferred-flush decode: (by array name
    [L, B, KVH(, hd)] buffers, and for each layer its views of them by array
    name), into which each layer's ``_cache_rows`` writes its rows, so that
    the flush reads them where they lie.  An INT8 (dense or paged) or bf16
    cache makes its rows by a quant or a cast anyway; an f32 cache's rows
    need no cast, and ``_flush`` stacks them: (None, [None] * L)."""
    L, KVH, hd = cache.k.shape[0], cache.k.shape[2], cache.k.shape[4]
    dt, dev = cache.k.dtype, cache.k.device
    if dt == torch.float32:
        return None, [None] * L
    bufs = {n: torch.empty((L, B, KVH, hd), dtype=dt, device=dev) for n in ("k", "v")}
    if dt == torch.int8:
        bufs.update({n: torch.empty((L, B, KVH), dtype=torch.float32, device=dev)
                     for n in ("ks", "vs")})
    return bufs, [dict(zip(bufs, t)) for t in zip(*(b.unbind(0) for b in bufs.values()))]


def _flush(cache, rows: list, pos32, bufs=None) -> None:
    """One flush of every layer's fresh rows (each layer's ``_cache_rows``)
    at pos: from the step's buffers ``bufs`` where the rows were written
    (``_flush_buffers``), else (an f32 cache) from one [L, ...] stack per
    array; then K10 (K14 on a paged cache)."""
    st = bufs if bufs is not None else {n: torch.stack([r[n] for r in rows]) for n in rows[0]}
    if isinstance(cache, PagedKVCache):
        kv_pool_flush_rows(st["k"], st["v"], st["ks"], st["vs"], pos32, cache.page_table,
                           cache.k, cache.v, cache.ks, cache.vs)
        return
    kv_cache_flush_rows(st["k"], st["v"], pos32, cache.k, cache.v, st.get("ks"), st.get("vs"),
                        cache.ks, cache.vs)


def decode_stack(layers: LayerParams, cache, x, pos, cos, sin, config: ModelConfig,
                 attn: str = "xla", precision: str = "highest", splits: dict | None = None,
                 row_mm=None):
    """The unfused decode layer stack (llama.py:1206): x [B, D] in -> x out;
    writes every layer's new K/V row into ``cache`` in place -- per layer
    for ``attn="xla"``, in one K10 flush after the layer loop for the
    deferred-flush ``"flash"`` (K19) and ``"flash_dma"`` (K9).  On an fp
    cache the fresh rows are cast to its dtype and the kernels' fp forms
    run (llama.py:1308-1327).  On a paged cache (llama.py:1237-1276) every
    mode is deferred-flush: the pool is read-only during the layer loop,
    each layer attends through K13 (K20 for ``"flash"``), and one K14 flush
    writes every layer's row after it.  ``splits`` (``split_counts``)
    pins the attention's key-row splits; ``row_mm`` takes the place of
    ``matmul_any`` for wo and w2 (the sharded engine's row-sharded
    products, ``parallel.spmd``)."""
    B = x.shape[0]
    attn = _resolve_decode_attn(attn, cache)
    row_mm = row_mm or matmul_any
    sp = (splits or {}).get(attn)
    NH, KVH, G, hd = config.n_heads, config.n_kv_heads, config.group_size, config.head_dim
    L = layers.rms_att.shape[0]
    flash = attn != "xla" or isinstance(cache, PagedKVCache)
    if flash:
        attend = _decode_attend(attn, cache)
        pos32 = pos.to(torch.int32)  # once per step, read on the device by the kernels
        rows = []  # each layer's fresh rows, for the flush (the JAX scan's ys)
        bufs, views = _flush_buffers(cache, B)
    for i in range(L):
        lp = layers.layer(i)
        h = rmsnorm(x, lp.rms_att)
        q, k, v = _project_qkv(h, lp, config, precision)
        q = apply_rope(q.reshape(B, NH, hd), cos, sin)
        k = apply_rope(k.reshape(B, KVH, hd), cos, sin)
        v = v.reshape(B, KVH, hd)
        if flash:
            rows.append(_cache_rows(cache, k, v, views[i]))
            att = _attend_fresh(attend, q.reshape(B, KVH, G, hd), cache, pos32, rows[-1], i,
                                sp)
            att = att.reshape(B, config.dim).to(x.dtype)
        else:
            _write_decode(cache, i, k, v, pos, config)
            att = _attend_decode(cache, i, q, pos, config)
        x = row_mm(att, lp.wo, residual=x, precision=precision)
        h = rmsnorm(x, lp.rms_ffn)
        gate, up = _project_gate_up(h, lp, config, precision)
        x = row_mm(F.silu(gate) * up, lp.w2, residual=x, precision=precision)
    if flash:
        _flush(cache, rows, pos32, bufs)
    return x


def _fused_path_ok(params: LlamaParams, config: ModelConfig) -> bool:
    """The fused decode's weights (llama.py:657): W8A8 in the fused wqkv /
    w13 layouts.  The TPU's 128-alignment and VMEM gates are Mosaic rules
    that K11 and K12 do not have."""
    lp = params.layers
    return (all(isinstance(w, ChannelQuantTensor) for w in (lp.wq, lp.wo, lp.w1, lp.w2))
            and _fused_layouts(lp, config))


def _mega2_path_ok(params: LlamaParams, config: ModelConfig, cache, B: int) -> bool:
    """What K12 takes (llama.py:683): a dense INT8 cache, any even head_dim
    <= 128 that is a multiple of 4 and up to 8 query heads per kv head (K9's
    cell), and up to ``MAX_ROWS`` slots.  Not the TPU's head_dim % 128."""
    hd = config.head_dim
    return (isinstance(cache, QuantKVCache) and cache.k.dtype == torch.int8
            and hd <= 128 and hd % 4 == 0 and config.group_size <= 8 and B <= MAX_ROWS)


def _mega3_path_ok(params: LlamaParams, config: ModelConfig, cache, B: int) -> bool:
    """What K26 takes (llama.py:808): mega2's cache, widths and slots, and
    an even layer count (it pairs layers).  Not the TPU's head_dim % 128 or
    its ``step3_plan`` VMEM rule."""
    return _mega2_path_ok(params, config, cache, B) and config.n_layers % 2 == 0


def _mega_path_ok(params: LlamaParams, config: ModelConfig, cache, B: int) -> bool:
    """What K27 takes (llama.py:920): a dense INT8 cache, up to
    ``MAX_ROWS`` slots, up to 8 query heads per kv head and head_dim <= 128
    (K9's cell, whose cache rows are copied in 4-byte chunks: a multiple
    of 4).  Not the TPU's head_dim % 128, its VMEM plan or its TPU block."""
    return _mega2_path_ok(params, config, cache, B)


FUSED_MODES = (False, True, "mega2", "mega3", "mega", "auto")


def _resolve_fused(fused, attn: str, params: LlamaParams, config: ModelConfig, cache, B: int):
    """``forward_decode``'s fused-decode policy, the structure of llama.py:
    1131-1194.  ``"auto"`` is False on a CPU cache, as the JAX package on
    the CPU.  On a CUDA cache with a flash attention, weights that
    ``_fused_path_ok`` takes and at most MAX_ROWS slots, it is ``"mega2"``
    where ``_mega2_path_ok`` holds, else True: on an H100 mega2 (K12) took
    fewer device-ms and host-ms per step than the two-launch decode (K11 +
    K9) and the unfused one at batch 8 and batch 1, position 512
    (``profile_serving.py``, the A/B in PERF.md).  ``"mega3"`` (K26, two
    layers a launch) and ``"mega"`` (K27, the attention leading each
    layer's launch) are taken only when asked for: JAX's ``"auto"`` never
    picks either (off the TPU its fused decode is off, llama.py:1132-1134;
    on the TPU ``_mega_path_ok`` refuses, :938), and neither does the
    port's.  An explicit mode that its gate refuses raises ValueError."""
    if fused not in FUSED_MODES:
        raise ValueError(f"fused decode {fused!r}: want one of {FUSED_MODES}")
    if not isinstance(fused, str):
        fused = bool(fused)
    if fused == "auto":
        if (cache.k.device.type != "cuda" or attn not in ("flash", "flash_dma")
                or not _fused_path_ok(params, config) or B > MAX_ROWS):
            return False
        return "mega2" if _mega2_path_ok(params, config, cache, B) else True
    if fused == "mega2" and not (_fused_path_ok(params, config)
                                 and _mega2_path_ok(params, config, cache, B)):
        raise ValueError("mega2 decode requires fused W8A8 layouts, a dense INT8 cache, an "
                         f"even head_dim <= 128 (a multiple of 4), at most 8 query heads per "
                         f"kv head and at most {MAX_ROWS} slots")
    if fused == "mega3" and not (_fused_path_ok(params, config)
                                 and _mega3_path_ok(params, config, cache, B)):
        raise ValueError("mega3 decode requires fused W8A8 layouts, a dense INT8 cache, "
                         "128-aligned head_dim, and an even layer count (the port: a head_dim "
                         "<= 128 that is a multiple of 4, at most 8 query heads per kv head "
                         f"and at most {MAX_ROWS} slots)")
    if fused == "mega" and not (_fused_path_ok(params, config)
                                and _mega_path_ok(params, config, cache, B)):
        raise ValueError("mega decode requires fused W8A8 layouts, a dense INT8 cache, and "
                         "128-aligned head_dim (the port: a head_dim <= 128 that is a multiple "
                         f"of 4, at most 8 query heads per kv head and at most {MAX_ROWS} "
                         "slots)")
    if fused is True:
        if attn not in ("flash", "flash_dma"):
            raise ValueError("fused decode requires a flash attention impl")
        if not _fused_path_ok(params, config) or B > MAX_ROWS:
            raise ValueError(f"fused decode requires fused W8A8 layouts and at most "
                             f"{MAX_ROWS} slots")
    return fused


def _decode_prologue(layers: LayerParams, x0, config: ModelConfig):
    """Layer 0's qkv for the fused decode (llama.py:996-1004): the f32
    embedding rows through K3 (rmsnorm + quant: on an f32 input the math of
    JAX's rmsnorm then quantize_activations) and K8."""
    xq0, sx0 = rmsnorm_quantize(x0, layers.rms_att[0])
    return w8a8_matmul_stacked(xq0, sx0, layers.wq, 0)


def _split_qkv(qkv, cos, sin, config: ModelConfig):
    """f32 [B, QO] -> roped q [B, KVH, G, hd], and k, v quantized per head
    ((kq, ks), (vq, vs)), as the JAX scan body does in XLA."""
    q, k, v = _split_rope(qkv, cos, sin, config)
    return q, quantize_kv(k), quantize_kv(v)


def _split_rope(qkv, cos, sin, config: ModelConfig):
    """f32 [B, QO] -> roped q [B, KVH, G, hd], roped k and v [B, KVH, hd]."""
    B = qkv.shape[0]
    D, KVD, NH, KVH, hd = (config.dim, config.kv_dim, config.n_heads, config.n_kv_heads,
                           config.head_dim)
    q = apply_rope(qkv[:, :D].reshape(B, NH, hd), cos, sin)
    k = apply_rope(qkv[:, D:D + KVD].reshape(B, KVH, hd), cos, sin)
    v = qkv[:, D + KVD:].reshape(B, KVH, hd)
    return q.reshape(B, KVH, config.group_size, hd), k, v


def fused_decode_stack(layers: LayerParams, cache, x0, pos, cos, sin, config: ModelConfig,
                       attn: str, mega: bool = False, splits: dict | None = None):
    """The two-launch fused decode layer stack (llama.py:978-1096): x0
    [B, D] in -> x f32 [B, D].  On a paged cache the attention is K13 (K20
    for ``"flash"``) and the flush K14 (llama.py:1009-1018, 1049-1054,
    1079-1085).  Per layer the
    attention (K9 for ``"flash_dma"``, K19 for ``"flash"``; their fp forms
    on an fp cache, the fresh rows cast to its dtype) on the qkv the
    previous K11 launch left, K2 on its output, then K11 (the layer's linear
    work and the next layer's qkv); layer 0's qkv from the prologue (K3,
    K8).  ``mega=True`` (a dense INT8 cache; llama.py:1040-1047): per layer
    RoPE and quantize_kv, then one K27 launch -- the attention, its quant
    and K11's phases -- in place of the attention, K2 and K11; ``attn`` goes
    unread.  The residual stream stays f32 across layers, as JAX's scan
    carry.  One K10 flush writes every layer's row after the loop.
    ``splits`` (``split_counts``) pins the attention's key-row splits."""
    B, D = x0.shape
    splits = splits or {}
    L = layers.rms_att.shape[0]
    attend = None if mega else _decode_attend(attn, cache)
    pos32 = pos.to(torch.int32)
    x = x0.float()
    qkv = _decode_prologue(layers, x, config)
    rows = []
    bufs, views = _flush_buffers(cache, B)
    for i in range(L):
        q, k, v = _split_rope(qkv, cos, sin, config)
        rows.append(_cache_rows(cache, k, v, views[i]))
        if mega:
            r = rows[-1]
            x, qkv = fused_step_layer(x, q, r["k"], r["v"], r["ks"], r["vs"], cache.k, cache.v,
                                      cache.ks, cache.vs, pos32, layers.wo, layers.w1, layers.w2,
                                      layers.wq, layers.rms_ffn, layers.rms_att, i, L,
                                      splits=splits.get("fused"))
            continue
        att = _attend_fresh(attend, q, cache, pos32, rows[-1], i, splits.get(attn))
        attq, satt = quantize_activations(att.reshape(B, D))
        x, qkv = fused_layer_linear(x, attq, satt, layers.wo, layers.w1, layers.w2, layers.wq,
                                    layers.rms_ffn, layers.rms_att, i, L)
    _flush(cache, rows, pos32, bufs)
    return x


def _mega_prologue(layers: LayerParams, cache: QuantKVCache, x, pos32, cos, sin,
                   config: ModelConfig, splits: int | None = None):
    """mega2's and mega3's prologue (llama.py:743-769): layer 0's qkv (K3,
    K8), RoPE and quantize_kv, layer 0's attention (K9) and its quant (K2).
    Returns (attq, satt, rows): rows are the step's flush buffers (k, ks,
    v, vs) [L, B, ...], layer 0's rows in place."""
    B, D = x.shape
    L = layers.rms_att.shape[0]
    KVH, hd = config.n_kv_heads, config.head_dim
    q, (kq, ks), (vq, vs) = _split_qkv(_decode_prologue(layers, x, config), cos, sin, config)
    att = flash_decode_attention_dma(q, cache.k, cache.v, pos32, kq, vq, cache.ks, cache.vs,
                                     ks, vs, layer=0, splits=splits)
    attq, satt = quantize_activations(att.reshape(B, D))
    rows = (torch.empty((L, B, KVH, hd), dtype=torch.int8, device=x.device),
            torch.empty((L, B, KVH), dtype=torch.float32, device=x.device),
            torch.empty((L, B, KVH, hd), dtype=torch.int8, device=x.device),
            torch.empty((L, B, KVH), dtype=torch.float32, device=x.device))
    for dst, src in zip(rows, (kq, ks, vq, vs)):
        dst[0].copy_(src)
    return attq, satt, rows


def mega2_decode_stack(layers: LayerParams, cache: QuantKVCache, x0, pos, cos, sin,
                       config: ModelConfig, splits: dict | None = None):
    """The mega2 layer stack (llama.py:712-805): x0 [B, D] in -> x f32
    [B, D].  Prologue: K3 and K8 (layer 0's qkv), RoPE and quantize_kv,
    K9 (layer 0's attention), K2; then one K12 launch per layer (layer l's
    linear work and layer l + 1's attention), each writing layer l + 1's
    fresh rows straight into the step's flush buffers; one K10 flush.
    ``splits`` (``split_counts``) pins K9's and K12's key-row splits."""
    L = layers.rms_att.shape[0]
    pos32 = pos.to(torch.int32)
    x = x0.float()
    splits = splits or {}
    attq, satt, rows = _mega_prologue(layers, cache, x, pos32, cos, sin, config,
                                      splits.get("flash_dma"))
    for i in range(L):
        nxt = min(i + 1, L - 1)  # the last launch computes no rows: its buffers go unread
        x, attq, satt, *_ = fused_step2_layer(
            x, attq, satt, cache.k, cache.v, cache.ks, cache.vs, pos32, cos, sin, layers.wo,
            layers.w1, layers.w2, layers.wq, layers.rms_ffn, layers.rms_att, i, L,
            config.n_heads, out=tuple(r[nxt] for r in rows), splits=splits.get("fused"))
    kv_cache_flush_rows(rows[0], rows[2], pos32, cache.k, cache.v, rows[1], rows[3], cache.ks,
                        cache.vs)
    return x


def mega3_decode_stack(layers: LayerParams, cache: QuantKVCache, x0, pos, cos, sin,
                       config: ModelConfig, splits: dict | None = None):
    """The mega3 layer stack (llama.py:826-905): x0 [B, D] in -> x f32
    [B, D].  mega2's prologue, then one K26 launch per pair of layers
    (l0, l0 + 1): their linear work and the attentions of layers l0 + 1 and
    l0 + 2, writing both layers' fresh rows straight into the step's flush
    buffers (the last pair's second set goes to ``rows[L - 1]``, unwritten,
    as mega2's last launch); one K10 flush.  ``splits`` as mega2's."""
    L = layers.rms_att.shape[0]
    pos32 = pos.to(torch.int32)
    x = x0.float()
    splits = splits or {}
    attq, satt, rows = _mega_prologue(layers, cache, x, pos32, cos, sin, config,
                                      splits.get("flash_dma"))
    for l0 in range(0, L, 2):
        x, attq, satt, *_ = fused_step3_pair(
            x, attq, satt, cache.k, cache.v, cache.ks, cache.vs, pos32, cos, sin, layers.wo,
            layers.w1, layers.w2, layers.wq, layers.rms_ffn, layers.rms_att, l0, L,
            config.n_heads, out=tuple(tuple(r[i] for r in rows)
                                      for i in (l0 + 1, min(l0 + 2, L - 1))),
            splits=splits.get("fused"))
    kv_cache_flush_rows(rows[0], rows[2], pos32, cache.k, cache.v, rows[1], rows[3], cache.ks,
                        cache.vs)
    return x


def forward_decode(params: LlamaParams, cache, tokens: torch.Tensor, pos: torch.Tensor,
                   config: ModelConfig, attn: str = "auto", fused="auto",
                   precision: str = "highest", split_rows: int | None = None):
    """One decode step for a batch (llama.py:1101): tokens/pos [B].
    ``attn``: one of ``DECODE_ATTN`` (see ``_resolve_decode_attn``).
    ``fused`` (see ``_resolve_fused``): False runs the unfused
    ``decode_stack``; True the two-launch ``fused_decode_stack`` (K11 + the
    flash attention per layer); ``"mega2"`` ``mega2_decode_stack`` (K12);
    ``"mega3"`` ``mega3_decode_stack`` (K26); ``"mega"``
    ``fused_decode_stack(mega=True)`` (K27); ``"auto"`` picks from the
    device, the weights and the cache (never mega or mega3).  The fused
    paths carry the residual stream in f32 (llama.py:996) and run the
    classifier at "default" precision (llama.py:974).  ``precision``
    reaches dense float32 products (see ``dense_matmul``).  ``split_rows``
    (a dense cache): the batch the attention kernels' split rules read in
    place of B (``split_counts``), for a data-parallel rank that decodes a
    share of the slots as the whole batch decodes.  Returns (logits [B, V]
    f32, cache) -- the cache updated in place."""
    attn = _resolve_decode_attn(attn, cache)
    fused = _resolve_fused(fused, attn, params, config, cache, tokens.shape[0])
    tokens, pos = tokens.long(), pos.long()
    x = params.tok_emb[tokens]
    cos, sin = params.rope_cos[pos], params.rope_sin[pos]
    sp = (None if split_rows is None or isinstance(cache, PagedKVCache)
          else split_counts(cache, split_rows, config.n_kv_heads))
    if fused == "mega2":
        x = mega2_decode_stack(params.layers, cache, x, pos, cos, sin, config, sp)
    elif fused == "mega3":
        x = mega3_decode_stack(params.layers, cache, x, pos, cos, sin, config, sp)
    elif fused:
        x = fused_decode_stack(params.layers, cache, x, pos, cos, sin, config, attn,
                               mega=fused == "mega", splits=sp)
    else:
        x = decode_stack(params.layers, cache, x, pos, cos, sin, config, attn=attn,
                         precision=precision, splits=sp)
    x = rmsnorm(x, params.rms_final)
    prec = "default" if fused else precision
    return matmul_any(x, params.wcls, precision=prec).float(), cache


def _fused_qkv(x2, lp: LayerParams):
    """The fused body's qkv: K3 (rmsnorm + quant), then K1 on wqkv."""
    xq, sx = rmsnorm_quantize(x2, lp.rms_att)
    return w8a8_matmul_prequant(xq, sx, lp.wq, out_dtype=x2.dtype)


def _fused_tail(x2, att, lp: LayerParams, config: ModelConfig):
    """The fused body after attention (llama.py:1458-1469): K2 + K1 on wo
    with the residual, K3, K1 on w13, K4, K1 on w2 with the residual.
    x2 and att [M, D] -> x2 [M, D]."""
    H = config.hidden_dim
    x2 = matmul_any(att, lp.wo, residual=x2)
    hq, hs = rmsnorm_quantize(x2, lp.rms_ffn)
    gu = w8a8_matmul_prequant(hq, hs, lp.w1, out_dtype=x2.dtype)
    fq, fs = silu_mul_quantize(gu[:, :H], gu[:, H:])
    return w8a8_matmul_prequant(fq, fs, lp.w2, out_dtype=x2.dtype, residual=x2)


def _prefill_layer_fused(x, lp: LayerParams, cache: QuantKVCache, i: int, cos, sin, start0,
                         config: ModelConfig, attn: str):
    """Layer ``i`` of the fused W8A8 prefill body, ``layer_step_w8a8`` with
    ``attend_prequant`` (llama.py:1422-1469): x [B, T, D] in -> out, with
    f32 rmsnorm, RoPE and SiLU that are never rounded to x's dtype before
    their int8 quant (ops/quant.py).  K5 writes the layer's K/V straight
    into rows [0, T) of the INT8 ``cache`` (head-major, in place: no
    transpose, no copy) and K6 attends over them there -- for ``attn=
    "xla"``, JAX's ``attend()`` branch (llama.py:1485-1497), the f32
    ``attention_prefill`` on them instead (K5 keeps computing the rows: its
    f32 RoPE and quant are apply_rope + quantize_kv's arithmetic).
    cos/sin [B * T, hd/2], row b * T + t at position t."""
    B, T, D = x.shape
    NH, KVH, hd = config.n_heads, config.n_kv_heads, config.head_dim
    x2 = x.reshape(B * T, D)
    qkv = _fused_qkv(x2, lp)
    blocks = [a[i, :, :, :T] for a in (cache.k, cache.ks, cache.v, cache.vs)]  # [B, KVH, T..]
    q, *_ = rope_split_quantize(qkv, cos, sin, D, KVH, hd,
                                out=[blk.transpose(1, 2) for blk in blocks])
    kb, ksb, vb, vsb = blocks
    att = prefill_attention(attn)(q.view(B, T, NH, hd), kb, vb, start0, ksb, vsb,
                                  out_dtype=x.dtype)
    return _fused_tail(x2, att.view(B * T, D), lp, config).view(B, T, D)


def _prefill_layer_fused_fp(x, lp: LayerParams, cache: KVCache, i: int, cos, sin, start0,
                            config: ModelConfig, attn: str):
    """Layer ``i`` of the fused W8A8 prefill body over an fp cache,
    ``layer_step_w8a8`` with ``attend()``'s fp branch (llama.py:1431-1448,
    :1471-1508): K3 and K1 (qkv), RoPE on q and k in f32 cast back to x's
    dtype, k and v cast to the cache's dtype and written into rows [0, T)
    of ``cache``, K6's fp form over them (``attention_prefill`` for
    ``attn="xla"``), then the fused tail (K2 + K1, K3, K1, K4, K1).  No K5:
    it quantizes K/V for an INT8 cache.  cos/sin [T, hd/2]."""
    B, T, D = x.shape
    NH, KVH, hd, KVD = config.n_heads, config.n_kv_heads, config.head_dim, config.kv_dim
    x2 = x.reshape(B * T, D)
    qkv = _fused_qkv(x2, lp).view(B, T, -1)
    q = apply_rope(qkv[..., :D].reshape(B, T, NH, hd), cos, sin)
    k = apply_rope(qkv[..., D:D + KVD].reshape(B, T, KVH, hd), cos, sin)
    v = qkv[..., D + KVD:].reshape(B, T, KVH, hd)
    kb, vb = cache.k[i, :, :, :T], cache.v[i, :, :, :T]
    kb.copy_(k.transpose(1, 2))  # cast to the cache's dtype
    vb.copy_(v.transpose(1, 2))
    att = prefill_attention(attn)(q, kb, vb, start0, out_dtype=x.dtype)
    return _fused_tail(x2, att.view(B * T, D), lp, config).view(B, T, D)


def _forward_prefill_fresh(params: LlamaParams, cache, tokens, lengths, config: ModelConfig,
                           logits_mode: str, precision: str = "highest", attn: str = "flash"):
    """Prefill from position 0 (llama.py:1378): each layer leaves its K/V in
    rows [0, T) of ``cache``, in place, and attends over them (K6, start 0,
    or ``attention_prefill`` for ``attn="xla"``).
    Fused W8A8 layouts take the fused body at every shape -- with K5 on an
    INT8 cache (``_prefill_layer_fused``), with the fp attention on an fp
    one (``_prefill_layer_fused_fp``): the TPU gates of
    ``_prefill_w8a8_fast_ok`` (llama.py:1344-1375: B*T % 32, B*T <= 4096,
    no padding) and K5's ``head_dim % 128`` (llama.py:1433) are Mosaic
    rules that the CUDA kernels do not have.  Other weights (unfused W8A8,
    dense, Q8_0) take the unfused body (``_prefill_layer_at``)."""
    if logits_mode not in ("all", "last"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    B, T = tokens.shape
    if T > cache.seq_len:
        raise ValueError(f"{T} prompt rows do not fit a cache of {cache.seq_len}")
    x = params.tok_emb[tokens.long()]  # [B, T, D]
    cos, sin = params.rope_cos[:T], params.rope_sin[:T]  # broadcast over B
    start0 = torch.zeros((B,), dtype=torch.int32, device=x.device)
    layers = params.layers
    int8 = isinstance(cache, QuantKVCache)
    fused = _fused_w8a8(layers, config)
    if fused and int8:
        cos, sin = cos.repeat(B, 1), sin.repeat(B, 1)  # K5 takes one row per token
    for i in range(layers.rms_att.shape[0]):
        lp = layers.layer(i)
        if fused:
            step = _prefill_layer_fused if int8 else _prefill_layer_fused_fp
            x = step(x, lp, cache, i, cos, sin, start0, config, attn)
        else:
            x = _prefill_layer_at(x, lp, cache, i, cos, sin, start0, config, precision,
                                  attn=attn)
    if logits_mode == "last":
        x = _last_rows(x, lengths, T)
    return _logits(params, x, precision), cache


def _write_rows(cache, i: int, fresh: dict, start, config: ModelConfig, fits: bool) -> None:
    """Write a prefill's K/V IN PLACE into layer ``i`` at positions
    start[b] + t: ``fresh`` holds the cache's arrays by name
    (``_cache_rows``), values [B, T, KVH, hd] and scales [B, T, KVH]
    (llama.py:2133-2141, :2168-2191: ``.at[b, h, p].set``, a plain indexed
    copy).  ``fits`` says the caller knows on the host that every position
    lies inside the cache (max(start) + T <= S): then each row is written
    straight.  Otherwise positions can run past the cache, which the JAX
    package clips to S - 1, where a padding row (t >= lengths[b])
    overwrites the last row of a prompt that ends there; here such a row is
    not written.  It writes back the value already at (start + t) mod S
    instead -- positions distinct for T <= S and never one this call writes
    -- which needs no host sync but reads the destination rows first.
    Padding rows inside the cache are written, as in JAX: no real query
    attends them, and decode overwrites each before it is read."""
    B, T = fresh["k"].shape[:2]
    S = cache.seq_len
    dev = fresh["k"].device
    pos = start.long()[:, None] + torch.arange(T, device=dev)[None, :]  # [B, T]
    b_ix = torch.arange(B, device=dev)[:, None, None]
    h_ix = torch.arange(config.n_kv_heads, device=dev)[None, :, None]
    p_ix = (pos % S)[:, None, :]
    inside = (pos < S)[:, None, :]  # [B, 1, T]
    for n, rows in fresh.items():
        dst = getattr(cache, n)[i]  # [B, KVH, S(, hd)]
        new = rows.transpose(1, 2)  # [B, KVH, T(, hd)]
        if not fits:
            keep = inside if new.dim() == 3 else inside[..., None]
            new = torch.where(keep, new, dst[b_ix, h_ix, p_ix])
        dst[b_ix, h_ix, p_ix] = new


def _attend_layer(q, cache, i: int, start, out_dtype, attn: str):
    """K6 (its INT8 or fp form; ``attention_prefill`` for ``attn="xla"``)
    over all of layer ``i``'s cache rows, queries at start[b] + t."""
    scales = (cache.ks[i], cache.vs[i]) if isinstance(cache, QuantKVCache) else ()
    return prefill_attention(attn)(q, cache.k[i], cache.v[i], start, *scales,
                                   out_dtype=out_dtype)


def _prefill_layer_at(x, lp: LayerParams, cache, i: int, cos, sin, start, config: ModelConfig,
                      precision: str = "highest", fits: bool = True, attn: str = "flash",
                      row_mm=None):
    """Layer ``i`` of the unfused prefill body at any start (``layer_step``,
    llama.py:1510-1518, :2153-2204): the projections through
    ``matmul_any``, RoPE at each row's own positions, the K/V quantized
    (INT8 cache) or cast to the cache's dtype (fp), written at start + t
    (``_write_rows``; ``fits`` as there), then ``_attend_layer`` over the
    layer's cache (K6, or ``attention_prefill`` for ``attn="xla"``).
    cos/sin [B, T, hd/2] or [T, hd/2].  ``row_mm`` takes the place of
    ``matmul_any`` for wo and w2 (``decode_stack``'s)."""
    B, T = x.shape[:2]
    row_mm = row_mm or matmul_any
    NH, KVH, hd = config.n_heads, config.n_kv_heads, config.head_dim
    h = rmsnorm(x, lp.rms_att)
    q, k, v = _project_qkv(h, lp, config, precision)
    q = apply_rope(q.reshape(B, T, NH, hd), cos, sin)
    k = apply_rope(k.reshape(B, T, KVH, hd), cos, sin)
    _write_rows(cache, i, _cache_rows(cache, k, v.reshape(B, T, KVH, hd)), start, config, fits)
    att = _attend_layer(q, cache, i, start, x.dtype, attn)
    x = row_mm(att, lp.wo, residual=x, precision=precision)
    h = rmsnorm(x, lp.rms_ffn)
    gate, up = _project_gate_up(h, lp, config, precision)
    return row_mm(F.silu(gate) * up, lp.w2, residual=x, precision=precision)


def _prefill_layer_fused_at(x, lp: LayerParams, cache: QuantKVCache, i: int, cos, sin, start,
                            config: ModelConfig, fits: bool, attn: str):
    """Layer ``i`` of the fused W8A8 body at any start over an INT8 cache
    (``layer_step_w8a8``, llama.py:2112-2151): K3, K1 (qkv), K5 into compact
    q/k/v with RoPE at each row's own positions, the write at start + t
    (``_write_rows``; ``fits`` as there), ``_attend_layer`` over the
    layer's cache, then the fused tail.
    cos/sin [B * T, hd/2], row b * T + t at position start[b] + t."""
    B, T, D = x.shape
    NH, KVH, hd = config.n_heads, config.n_kv_heads, config.head_dim
    x2 = x.reshape(B * T, D)
    q, kq, ks, vq, vs = rope_split_quantize(_fused_qkv(x2, lp), cos, sin, D, KVH, hd)
    fresh = {"k": kq.view(B, T, KVH, hd), "v": vq.view(B, T, KVH, hd),
             "ks": ks.view(B, T, KVH), "vs": vs.view(B, T, KVH)}
    _write_rows(cache, i, fresh, start, config, fits)
    att = _attend_layer(q.view(B, T, NH, hd), cache, i, start, x.dtype, attn)
    return _fused_tail(x2, att.view(B * T, D), lp, config).view(B, T, D)


def _dense_only(cache, name: str) -> None:
    """The prefills write a dense cache; a paged one is filled through a
    compact block and K15 (``Engine``), or straight from the chunks by
    ``forward_prefill_paged_chunked`` (K16, K17)."""
    if isinstance(cache, PagedKVCache):
        raise TypeError(
            f"{name} takes a dense cache: prefill a compact cache and land it with "
            "kv_pool_scatter_pages (Engine does), or prefill straight into the pool with "
            "forward_prefill_paged_chunked")


def forward_prefill_paged_chunked(params: LlamaParams, cache: PagedKVCache, tokens: torch.Tensor,
                                  lengths: torch.Tensor, slots, config: ModelConfig,
                                  precision: str = "default", chunk: int = 256, start0: int = 0,
                                  max_pos: int | None = None):
    """Chunked prefill straight into the page pool (llama.py:1772-2011): no
    compact [L, B, KVH, T, hd] block, no dense gather -- the pool is both
    the attention operand and the write target, and the temporaries are
    O(B x chunk).  Returns (next-token logits [B, V], cache), the pool
    written in place.

    ``tokens`` [B, T] are this wave's prompt slice at absolute positions
    [start0, start0 + T) of slots ``slots`` (host ints, or a tensor: rows of
    the page table, whose pages the caller reserved); ``lengths`` [B] are
    the ABSOLUTE prompt lengths; ``max_pos`` (default start0 + T) bounds
    start0 + T across the waves of one prompt and sizes the past-page walk.
    Raises ValueError unless T and the page size are multiples of
    ``chunk``, ``start0`` is a non-negative multiple of ``chunk`` (K17's
    contract: a chunk never crosses a page), start0 + T <= max_pos, and
    ceil(max_pos / ps) fits the page table (the JAX package asserts only
    the last).  Each chunk's positions past a slot's reservation go through
    table entries 0, the trash page: those rows are written there, read only
    by padding queries, and discarded.

    Per chunk (one Python loop: JAX's scan and unroll forms are TPU compile
    workarounds) and layer: on fused W8A8 layouts the stages of
    ``layer_step_w8a8`` -- K3, K1 (qkv), K5 into a head-major chunk block,
    K16 over the slots' past pages plus the block, K17 landing the block,
    then K2 + K1 (wo) with the residual, K3, K1 (w13), K4, K1 (w2) with the
    residual -- at every shape (JAX's ``ffn_split`` rows and its fused gate
    were TPU HBM and compile-helper rules); on other weights the unfused
    ``layer_step``: rmsnorm, the projections (``matmul_any``), RoPE,
    ``quantize_kv`` before the head-major transpose, K16, K17, then wo and
    the FFN.  Each chunk runs the classifier at each row's last valid
    position inside it; each row keeps the logits of the chunk that holds
    its final token.  A row whose final token lies outside this wave gets
    the logits of the wave's first or last chunk (clipped): well formed,
    and to be discarded by the caller, as in JAX."""
    if not isinstance(cache, PagedKVCache):
        raise TypeError("forward_prefill_paged_chunked prefills a PagedKVCache")
    B, T = tokens.shape
    ps = cache.page_size
    start0 = int(start0)
    mpos = start0 + T if max_pos is None else int(max_pos)
    if chunk <= 0 or T % chunk or ps % chunk:
        raise ValueError(f"{T} prompt rows and pages of {ps} must be multiples of the chunk "
                         f"{chunk}")
    if start0 < 0 or start0 % chunk:
        raise ValueError(f"start0 {start0} must be a non-negative multiple of the chunk {chunk}")
    if start0 + T > mpos:
        raise ValueError(f"the wave's positions [{start0}, {start0 + T}) pass max_pos {mpos}")
    MP = cache.page_table.shape[1]
    if -(-mpos // ps) > MP:
        raise ValueError(f"max_pos {mpos} needs {-(-mpos // ps)} pages a slot, but the page "
                         f"table holds {MP}: raise seq_len or reject the request at admission")
    dev = cache.k.device
    idx = (slots.to(dev).long() if isinstance(slots, torch.Tensor)
           else upload([int(s) for s in slots], dev, torch.long))
    if idx.shape != (B,):
        raise ValueError(f"{idx.shape[0]} slots for {B} prompts")
    # the pages that can hold past keys (a start is at most mpos - chunk)
    past_pages = -(-(mpos - chunk) // ps)
    pt = cache.page_table.index_select(0, idx)[:, :max(1, -(-mpos // ps))].contiguous()
    lengths = lengths.to(device=dev, dtype=torch.long)
    layers = params.layers
    L = layers.rms_att.shape[0]
    D, NH, KVH, hd = config.dim, config.n_heads, config.n_kv_heads, config.head_dim
    fused = _fused_w8a8(layers, config)
    if fused:
        blk, outs = _chunk_block(B, KVH, chunk, hd, dev)
    n = T // chunk
    per_chunk = []
    for i in range(n):
        c0 = i * chunk  # wave-relative: indexes this wave's tokens
        a0 = start0 + c0  # absolute: RoPE phases, pool rows, the past-key walk
        start = torch.full((B,), a0, dtype=torch.int32, device=dev)
        cos, sin = params.rope_cos[a0:a0 + chunk], params.rope_sin[a0:a0 + chunk]
        x = params.tok_emb[tokens[:, c0:c0 + chunk].long()]
        if fused:
            cos, sin = cos.repeat(B, 1), sin.repeat(B, 1)  # K5 takes one row per token
        for l in range(L):
            lp = layers.layer(l)
            if fused:
                x2 = x.reshape(B * chunk, D)
                q, *_ = rope_split_quantize(_fused_qkv(x2, lp), cos, sin, D, KVH, hd, out=outs)
                rows = blk[0], blk[2], blk[1], blk[3]
            else:
                h = rmsnorm(x, lp.rms_att)
                q, k, v = _project_qkv(h, lp, config, precision)
                q = apply_rope(q.reshape(B, chunk, NH, hd), cos, sin)
                k = apply_rope(k.reshape(B, chunk, KVH, hd), cos, sin)
                # quantized before the head-major transpose (llama.py:1946-1953)
                (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v.reshape(B, chunk, KVH, hd))
                rows = tuple(a.transpose(1, 2).contiguous() for a in (kq, vq, ks, vs))
            att = paged_flash_prefill_attention(
                q.view(B, chunk, NH, hd), cache.k, cache.v, cache.ks, cache.vs, pt, start, *rows,
                layer=l, past_pages=past_pages, out_dtype=x.dtype)
            kv_pool_write_chunk(*rows, pt, start, l, cache.k, cache.v, cache.ks, cache.vs)
            if fused:
                x = _fused_tail(x2, att.view(B * chunk, D), lp, config).view(B, chunk, D)
            else:
                x = matmul_any(att, lp.wo, residual=x, precision=precision)
                h = rmsnorm(x, lp.rms_ffn)
                gate, up = _project_gate_up(h, lp, config, precision)
                x = matmul_any(F.silu(gate) * up, lp.w2, residual=x, precision=precision)
        per_chunk.append(_logits(params, _last_rows(x, lengths - a0, chunk), precision))
    owner = torch.div(lengths - 1 - start0, chunk, rounding_mode="floor").clamp(0, n - 1)
    return torch.stack(per_chunk)[owner, torch.arange(B, device=dev)], cache


def _logits(params: LlamaParams, x, precision: str = "highest"):
    """Final rmsnorm, then the classifier (``matmul_any``), in f32."""
    return matmul_any(rmsnorm(x, params.rms_final), params.wcls, precision=precision).float()


def _last_rows(x, lengths, T: int):
    """x [B, T, D] at each row's final valid position, clamped to [0, T)."""
    rows = (lengths.long() - 1).clamp(0, T - 1)
    return x[torch.arange(x.shape[0], device=x.device), rows]


def forward_prefill(params: LlamaParams, cache, tokens: torch.Tensor, start_pos: torch.Tensor,
                    lengths: torch.Tensor, config: ModelConfig, logits_mode: str = "all",
                    assume_fresh: bool = False, precision: str = "highest", attn: str = "auto"):
    """Batched causal prefill (llama.py:2052).  Returns (logits, cache):
    [B, T, V] for ``logits_mode="all"``, [B, V] at lengths-1 for "last";
    the cache (INT8 or fp) is written in place.  ``assume_fresh=True``
    promises start_pos == 0 and takes ``_forward_prefill_fresh``.  Otherwise
    row b's tokens sit at positions start_pos[b] + t: each layer writes its
    K/V at those positions that lie inside the cache (``_write_rows``) and
    K6 attends over the layer's whole cache, which already holds rows
    [0, start_pos[b]).  Give ``start_pos`` on the host (a CPU tensor) where
    it is known there: it is uploaded without waiting, and where every row
    fits the cache the writes skip the guard for rows past it.
    ``attn`` (``PREFILL_ATTN``) is the JAX package's: ``"flash"`` attends
    through K6, ``"xla"`` through ``attention_prefill``, and ``"auto"`` is
    ``"flash"`` on a CUDA cache and ``"xla"`` on a CPU one
    (``_resolve_prefill_attn``).
    Fused W8A8 layouts over an INT8 cache take the fused body at every shape
    and with either attention (the gates of llama.py:2108-2110 -- B * T,
    head_dim % 128, ``attn == "flash"`` -- pick JAX's XLA body on the TPU;
    the attention is the only arithmetic that differs, and it follows
    ``attn``); everything else takes the unfused body.  ``precision``
    reaches dense float32 products (``dense_matmul``)."""
    _dense_only(cache, "forward_prefill")
    attn = _resolve_prefill_attn(attn, cache)
    if assume_fresh:
        return _forward_prefill_fresh(params, cache, tokens, lengths, config, logits_mode,
                                      precision, attn)
    if logits_mode not in ("all", "last"):
        raise ValueError(f"unknown logits_mode {logits_mode!r}")
    B, T = tokens.shape
    S = cache.seq_len
    dev = tokens.device
    host = start_pos.device.type == "cpu"
    fits = host and int(start_pos.max()) + T <= S
    start = (upload(start_pos, dev, torch.int32) if host
             else start_pos.to(device=dev, dtype=torch.int32))
    lengths = lengths.to(device=dev, dtype=torch.long)
    pos = (start.long()[:, None] + torch.arange(T, device=dev)[None, :]).clamp(0, S - 1)
    cos, sin = params.rope_cos[pos], params.rope_sin[pos]  # [B, T, hd/2]
    x = params.tok_emb[tokens.long()]
    layers = params.layers
    if _fused_w8a8(layers, config) and isinstance(cache, QuantKVCache):
        cos, sin = cos.reshape(B * T, -1), sin.reshape(B * T, -1)
        for i in range(layers.rms_att.shape[0]):
            x = _prefill_layer_fused_at(x, layers.layer(i), cache, i, cos, sin, start, config,
                                        fits, attn)
    else:
        for i in range(layers.rms_att.shape[0]):
            x = _prefill_layer_at(x, layers.layer(i), cache, i, cos, sin, start, config,
                                  precision, fits, attn)
    if logits_mode == "last":
        x = _last_rows(x, lengths, T)
    return _logits(params, x, precision), cache


def _chunk_block(B: int, KVH: int, chunk: int, hd: int, dev):
    """A chunk's head-major K/V block for K5 to write: the arrays k, ks, v,
    vs ([B, KVH, chunk(, hd)] int8 / f32) and their [B, chunk, KVH(, hd)]
    views, which K5's ``out`` takes."""
    blk = [torch.empty((B, KVH, chunk, *d), dtype=t, device=dev)
           for t, d in [(torch.int8, (hd,)), (torch.float32, ())] * 2]
    return blk, [b.transpose(1, 2) for b in blk]


def forward_prefill_chunked(params: LlamaParams, cache, tokens: torch.Tensor,
                            lengths: torch.Tensor, config: ModelConfig, chunk: int = 256,
                            precision: str = "highest", attn: str = "auto"):
    """Prefill from position 0 in chunks of ``chunk`` positions, each
    attending over every row written before it (llama.py:1562-1748; the
    JAX package's scan, unrolled and carry forms exist for TPU compile
    limits and are one function here).  Returns (next-token logits [B, V],
    cache); T must be a multiple of ``chunk`` and fit the cache.

    Fused W8A8 layouts over an INT8 cache run the carry form (llama.py:
    1693-1746, gated by ``_prefill_chunked_carry_ok`` :1751): per chunk i
    and layer l, K3, K1, K5 into a compact [B, KVH, chunk, hd] block, K18
    lands it at rows [i * chunk, (i + 1) * chunk) of layer l in place, K6
    (start i * chunk) over that layer, then the fused tail.  Everything else
    -- fp caches (K18 is INT8-only), dense, Q8_0 or unfused weights -- runs
    ``forward_prefill(start_pos=i * chunk)`` per chunk (llama.py:1580-1596).
    ``attn`` is ``forward_prefill``'s, which the JAX package's chunked
    prefill leaves at ``"auto"``: on a CPU cache its ``"xla"`` attention
    (``attention_prefill``) takes K6's place in the carry form too; an
    explicit ``"flash"`` there computes ``forward_prefill_chunked_carry``'s
    function, K6's plain version.  Each chunk computes its last-token
    logits; each row keeps those of the chunk that holds its final token."""
    _dense_only(cache, "forward_prefill_chunked")
    attn = _resolve_prefill_attn(attn, cache)
    B, T = tokens.shape
    if chunk <= 0 or T % chunk:
        raise ValueError(f"{T} prompt rows are not a multiple of the chunk {chunk}")
    if T > cache.seq_len:
        raise ValueError(f"{T} prompt rows do not fit a cache of {cache.seq_len}")
    n = T // chunk
    dev = tokens.device
    lengths = lengths.to(device=dev, dtype=torch.long)
    layers = params.layers
    carry = _fused_w8a8(layers, config) and isinstance(cache, QuantKVCache)
    if carry:
        D, NH, KVH, hd = config.dim, config.n_heads, config.n_kv_heads, config.head_dim
        blk, outs = _chunk_block(B, KVH, chunk, hd, dev)
    per_chunk = []
    for i in range(n):
        c0 = i * chunk
        tok_c = tokens[:, c0:c0 + chunk]
        len_c = (lengths - c0).clamp(1, chunk)
        if not carry:  # the start on the host: every chunk's rows fit
            logits_c, cache = forward_prefill(params, cache, tok_c,
                                              torch.full((B,), c0, dtype=torch.int32), len_c,
                                              config, logits_mode="last", precision=precision,
                                              attn=attn)
            per_chunk.append(logits_c)
            continue
        start = torch.full((B,), c0, dtype=torch.int32, device=dev)
        cos = params.rope_cos[c0:c0 + chunk].repeat(B, 1)  # [B * chunk, hd/2], row b * chunk + t
        sin = params.rope_sin[c0:c0 + chunk].repeat(B, 1)
        x = params.tok_emb[tok_c.long()]
        for l in range(layers.rms_att.shape[0]):
            lp = layers.layer(l)
            x2 = x.reshape(B * chunk, D)
            q, *_ = rope_split_quantize(_fused_qkv(x2, lp), cos, sin, D, KVH, hd, out=outs)
            kv_cache_write_chunk(blk[0], blk[2], blk[1], blk[3], c0, l, cache.k, cache.v,
                                 cache.ks, cache.vs)
            att = _attend_layer(q.view(B, chunk, NH, hd), cache, l, start, x.dtype, attn)
            x = _fused_tail(x2, att.view(B * chunk, D), lp, config).view(B, chunk, D)
        per_chunk.append(_logits(params, _last_rows(x, len_c, chunk), precision))
    owner = ((lengths - 1) // chunk).clamp(0, n - 1)
    return torch.stack(per_chunk)[owner, torch.arange(B, device=dev)], cache


def greedy_decode_loop(params: LlamaParams, cache, tokens: torch.Tensor, pos: torch.Tensor,
                       steps: int, config: ModelConfig, attn: str = "auto", fused="auto",
                       precision: str = "highest"):
    """``steps`` greedy decode steps (llama.py:2016) as a Python loop: the
    argmax feeds back on the device.  Returns (tokens [B, steps], cache)."""
    toks, p, out = tokens.long(), pos.long(), []
    for _ in range(steps):
        logits, cache = forward_decode(params, cache, toks, p, config, attn=attn, fused=fused,
                                       precision=precision)
        toks = logits.argmax(dim=-1)
        out.append(toks)
        p = p + 1
    return torch.stack(out, dim=1), cache

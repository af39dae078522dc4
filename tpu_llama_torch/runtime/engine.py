"""Inference engine over a slot-based dense INT8 KV cache.

Port of tpu_llama/runtime/engine.py for the dense INT8 path:

* the cache has ``max_batch`` slots; requests hold slots independently, each
  at its own position;
* admission runs a compact batched prefill of the new prompts only (prompt
  length bucketed to a power of two) into a T-row block, then the K7 slot
  scatter writes that block into the chosen slots in place;
* decode runs the full slot batch in one step -- inactive slots compute
  values nobody reads (they decode at position 0; their row lands there and
  the next admission's K7 scatter overwrites it).  With the deferred-flush
  attention (``attn="flash_dma"`` K9, what ``"auto"`` picks on the card,
  or ``"flash"`` K19) no layer writes the cache during the step: one K10
  flush after the layer loop writes every layer's row.  ``"xla"`` (what
  ``"auto"`` picks on the CPU) writes each layer's row in place before its
  attention.  On fused W8A8 layouts the card decodes through the fused
  decode (``fused="auto"``: mega2, one K12 launch per layer; ``True`` the
  two-launch K11 path; ``False`` the unfused one), ``Engine.decode_fused``
  shows the resolved mode.

JAX's donated functional cache becomes one cache object updated in place.
Paged caches, prefix reuse, device sampling and the explicit-TP paths come
with later slices (ROADMAP).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.device import resolve_device
from tpu_llama_torch.models.llama import (
    LlamaParams,
    QuantKVCache,
    _resolve_decode_attn,
    _resolve_fused,
    forward_decode,
    forward_prefill,
    make_kv_cache,
)
from tpu_llama_torch.ops.attention import kv_cache_scatter_slots

# Above this many prompt rows (Bp * T) the JAX engine switches to chunked
# prefill (engine.py:132-138), which the port does not carry yet.
_CHUNKED_ROWS = 8192


def _prefill_into_slots(params: LlamaParams, cache: QuantKVCache, tokens: torch.Tensor,
                        lengths: torch.Tensor, slots: Sequence[int], config: ModelConfig):
    """Compact prefill + scatter into the slot cache (engine.py:96).  Returns
    (next-token logits [Bp, V], cache) with the cache updated in place.  The
    scatter is K7 for every bucket: the TPU's ``T % 128`` gate was a Mosaic
    alignment rule that the CUDA kernel does not have.  ``slots`` stays on
    the host: K7's wrapper checks it there and copies it to the card once."""
    Bp, T = tokens.shape
    if T % 256 == 0 and Bp * T > _CHUNKED_ROWS:
        raise NotImplementedError("chunked prefill above 8192 prompt rows: ROADMAP "
                                  "queue 1 item 9")
    small = make_kv_cache(config, Bp, seq_len=T, device=tokens.device)
    last, small = forward_prefill(
        params, small, tokens, start_pos=torch.zeros_like(lengths), lengths=lengths,
        config=config, logits_mode="last", assume_fresh=True)
    kv_cache_scatter_slots(small.k, small.v, slots, cache.k, cache.v, small.ks,
                           small.vs, cache.ks, cache.vs)
    return last, cache


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class Engine:
    """Owns params + slot cache; batched prefill/decode with numpy in and
    out at the host boundary."""

    def __init__(self, params: LlamaParams, config: ModelConfig, max_batch: int = 8,
                 kv_dtype="int8", seq_len: int | None = None, kv_layout: str = "dense",
                 attn: str = "auto", fused="auto", device=None):
        if kv_layout != "dense":
            raise NotImplementedError("paged KV layout: ROADMAP queue 1 item 8")
        self.device = resolve_device(device)
        if params.tok_emb.device.type != self.device.type:
            raise ValueError(f"params live on {params.tok_emb.device}, the engine on "
                             f"{self.device}")
        self.params = params
        self.config = config
        self.max_batch = max_batch
        self.seq_len = seq_len or config.seq_len
        self.cache = make_kv_cache(config, max_batch, kv_dtype=kv_dtype,
                                   seq_len=self.seq_len, device=self.device)
        # the decode attention and fused decode every step runs ("auto"
        # resolved on these weights and this cache, as JAX's _decode_step
        # calls forward_decode with fused="auto", engine.py:308-320)
        self.decode_attn = _resolve_decode_attn(attn, self.cache)
        self.decode_fused = _resolve_fused(fused, self.decode_attn, params, config, self.cache,
                                           max_batch)

    def can_admit(self, n_tokens: int) -> bool:
        """Backpressure probe; a dense cache always has room in a free slot."""
        return True

    def release_slot(self, slot: int) -> None:
        """Return a retired slot (nothing to free on a dense cache)."""

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long).to(self.device)

    def prefill(self, prompts: Sequence[Sequence[int]], slots: Sequence[int],
                reserve_tokens: Sequence[int] | None = None, return_device: bool = False):
        """Prefill fresh prompts into slots.  Returns next-token logits [n, V]
        (numpy, or the device tensor with ``return_device=True``).

        The admission batch splits into power-of-two groups, largest first,
        each bucketing its own T (engine.py:533-561): a short-prompt group
        does not pay a long-prompt group's rows.  ``reserve_tokens`` is for
        paged caches and is ignored here."""
        if not prompts or len(prompts) != len(slots):
            raise ValueError("need one slot per prompt, and at least one prompt")
        lengths = np.array([len(p) for p in prompts], np.int64)
        if lengths.min() < 1:
            raise ValueError("prompts must be non-empty (include BOS)")
        if int(lengths.max()) > self.seq_len:
            raise ValueError("prompt exceeds cache")
        outs, start, n = [], 0, len(prompts)
        while start < n:
            g = 1 << ((n - start).bit_length() - 1)  # largest pow2 <= rest
            T = min(_bucket(int(lengths[start:start + g].max())), self.seq_len)
            toks = np.zeros((g, T), np.int64)
            for i, p in enumerate(prompts[start:start + g]):
                toks[i, :len(p)] = p
            last, self.cache = _prefill_into_slots(
                self.params, self.cache, self._ints(toks),
                self._ints(lengths[start:start + g]),
                [int(s) for s in slots[start:start + g]], self.config)
            outs.append(last)
            start += g
        last = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return last if return_device else last.cpu().numpy()

    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step over ALL slots. tokens/pos: [max_batch]."""
        return self.decode_device(self._ints(tokens), self._ints(pos)).cpu().numpy()

    def decode_device(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Device-resident decode step (no host transfer) for tight loops.
        (JAX's ``_decode_step``, engine.py:310, only exists to jit and donate
        the cache; here the step calls ``forward_decode`` directly.)"""
        logits, self.cache = forward_decode(self.params, self.cache, tokens, pos,
                                            self.config, attn=self.decode_attn,
                                            fused=self.decode_fused)
        return logits

    def reset(self) -> None:
        self.cache.zero_()

"""Perplexity harness: the quantization regression gate.

Port of tpu_llama/eval/ppl.py.  Teacher-forced negative log-likelihood over
a token stream, computed with the batched prefill (``forward_prefill``,
``logits_mode="all"``) on a fresh cache per chunk, f32 log-softmax whatever
the weights' dtype.  Runs on the device the params live on.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.models.llama import LlamaParams, forward_prefill, make_kv_cache


def _chunk_nll(params: LlamaParams, config: ModelConfig, tokens: np.ndarray,
               precision: str) -> tuple[float, int]:
    """Summed NLL of tokens[1:] given tokens[:-1] for one chunk (<= seq_len)."""
    T = len(tokens)
    dev = params.tok_emb.device
    cache = make_kv_cache(config, 1, seq_len=T, device=dev)
    logits, _ = forward_prefill(params, cache, torch.as_tensor(tokens, device=dev)[None, :],
                                torch.zeros(1, dtype=torch.long),
                                torch.tensor([T], device=dev), config, precision=precision)
    logp = torch.log_softmax(logits[0].float(), dim=-1)
    targets = torch.as_tensor(tokens[1:], device=dev).long()
    tok_logp = logp[:-1].gather(1, targets[:, None])[:, 0]
    return float(-tok_logp.sum()), T - 1


def perplexity(params: LlamaParams, config: ModelConfig, tokens: Sequence[int],
               chunk: int | None = None, precision: str = "default") -> float:
    """Teacher-forced perplexity over a token stream, in chunks of at most
    seq_len tokens that overlap by one (each chunk's first token is the
    previous chunk's last target)."""
    tokens = np.asarray(list(tokens), np.int64)
    chunk = min(chunk or config.seq_len, config.seq_len)
    total_nll, total_count = 0.0, 0
    for start in range(0, len(tokens) - 1, chunk - 1):
        piece = tokens[start:start + chunk]
        if len(piece) < 2:
            break
        nll, n = _chunk_nll(params, config, piece, precision)
        total_nll += nll
        total_count += n
    return math.exp(total_nll / max(total_count, 1))


def ppl_delta(params_a: LlamaParams, params_b: LlamaParams, config: ModelConfig,
              tokens: Sequence[int], **kw) -> tuple[float, float, float]:
    """Returns (ppl_a, ppl_b, ppl_b - ppl_a)."""
    pa = perplexity(params_a, config, tokens, **kw)
    pb = perplexity(params_b, config, tokens, **kw)
    return pa, pb, pb - pa

"""Reference-faithful generation loop (llama2.ts:460-511 semantics).

Port of tpu_llama/compat/generate.py (host code).  Drives any single-token
forward function (the numpy oracle, or an engine's logits) with exactly the
reference's state machine:

* start from ``token = BOS(1), pos = 0`` (llama2.ts:463-464)
* while in the prompt, teacher-force prompt tokens ("prefill is just
  sequential decode", SURVEY §3.3) (llama2.ts:471-474)
* temperature 0 -> argmax; else scale logits (f32 store), softmax (f32),
  then plain multinomial or nucleus top-p (llama2.ts:476-494)
* the RNG advances ONLY on sampled steps (SURVEY §3.5) -- stream order is
  part of the compatibility contract
* stop when ``next == BOS`` (llama2.ts:499); EOS is not special-cased
* detokenize with the BOS-space-strip rule (llama2.ts:502)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from tpu_llama_torch.compat.rng import Xorshift64Star
from tpu_llama_torch.compat.sampling import argmax, sample, sample_topp, scale_softmax_f32
from tpu_llama_torch.io.tokenizer import BOS, Tokenizer

ForwardFn = Callable[[int, int], np.ndarray]  # (token, pos) -> fp32 logits


@dataclasses.dataclass
class GenerationResult:
    tokens: list[int]  # every `next` token chosen (prompt-forced + sampled)
    text: str
    tokens_per_sec: float


def generate_compat(
    forward: ForwardFn,
    tokenizer: Tokenizer,
    prompt: str | None = None,
    steps: int = 256,
    temperature: float = 1.0,
    topp: float = 1.0,
    seed: int = 0,
    seq_len: int | None = None,
    on_token: Callable[[str], None] | None = None,
) -> GenerationResult:
    if seed == 0:
        seed = int(time.time() * 1000)  # llama2.ts:424 (Date.now())
    rng = Xorshift64Star(seed)

    if seq_len is not None and (steps <= 0 or steps > seq_len):
        steps = seq_len  # llama2.ts:439

    prompt_tokens = tokenizer.encode(prompt) if prompt else []

    out_tokens: list[int] = []
    pieces: list[str] = []
    token = BOS
    pos = 0
    start = 0.0
    while pos < steps:
        logits = forward(token, pos)

        if pos < len(prompt_tokens):
            next_tok = prompt_tokens[pos]
        elif temperature == 0.0:
            next_tok = argmax(logits)
        else:
            probs = scale_softmax_f32(np.asarray(logits, np.float32), temperature)
            if topp <= 0 or topp >= 1:
                next_tok = sample(probs, rng)
            else:
                next_tok = sample_topp(probs, topp, rng)
        pos += 1

        if next_tok == BOS:  # llama2.ts:499
            break

        piece = tokenizer.decode_token(next_tok, prev_token=token)
        pieces.append(piece)
        if on_token is not None:
            on_token(piece)
        out_tokens.append(next_tok)
        token = next_tok
        if start == 0.0:
            start = time.time()  # llama2.ts:507 -- timer starts after 1st token

    elapsed = max(time.time() - start, 1e-9) if start else 1e-9
    return GenerationResult(
        tokens=out_tokens,
        text="".join(pieces),
        tokens_per_sec=(pos - 1) / elapsed,
    )

"""Host-side samplers replicating the reference's exact edge semantics.

A copy of ``tpu_llama.compat.sampling``.  These run on fp32 probability
arrays with float64 arithmetic (JS numbers are IEEE float64):

* ``scale_softmax_f32`` — temperature and softmax with f32 stores
  (llama2.ts:481-485);
* ``argmax`` — ties resolve to the LOWEST index (llama2.ts:364-366).
* ``sample`` — multinomial CDF walk with ``randValue < cumProb``; falls
  through to token 0 (llama2.ts:368-376).
* ``sample_topp`` — nucleus sampling with the reference's two quirks: the
  final CDF walk is EXCLUSIVE of ``lastIdx`` and the fallthrough returns raw
  token id 0 (llama2.ts:378-394).  The descending sort is stable.
"""

from __future__ import annotations

import numpy as np

from tpu_llama_torch.compat.rng import Xorshift64Star


def scale_softmax_f32(logits: np.ndarray, temperature: float) -> np.ndarray:
    """The reference's logit pipeline (llama2.ts:481-485): the division by
    the temperature and the softmax's exps and quotients stored as f32,
    their arithmetic and the sum in f64."""
    scaled = (logits.astype(np.float64) / temperature).astype(np.float32)
    m = np.max(scaled)
    e = np.exp(scaled.astype(np.float64) - np.float64(m)).astype(np.float32)
    return (e.astype(np.float64) / float(np.sum(e.astype(np.float64)))).astype(np.float32)


def argmax(arr: np.ndarray) -> int:
    return int(np.argmax(arr))


def sample(probs: np.ndarray, rng: Xorshift64Star) -> int:
    total = float(np.sum(probs.astype(np.float64)))
    rand_value = rng.random_f32() * total
    cum = 0.0
    for i, p in enumerate(probs.astype(np.float64)):
        cum += p
        if rand_value < cum:
            return i
    return 0


def sample_topp(probs: np.ndarray, topp: float, rng: Xorshift64Star) -> int:
    p64 = probs.astype(np.float64)
    order = np.argsort(-p64, kind="stable")
    sorted_probs = p64[order]

    cum = 0.0
    last_idx = 0
    for i in range(sorted_probs.shape[0]):
        cum += sorted_probs[i]
        if cum > topp:
            last_idx = i
            break

    rand_value = rng.random_f32() * cum
    cum = 0.0
    for i in range(last_idx):  # EXCLUSIVE bound — llama2.ts:390
        cum += sorted_probs[i]
        if rand_value < cum:
            return int(order[i])
    return 0  # llama2.ts:393 — raw token id 0 fallthrough

"""Continuous-batching scheduler on the host-sampling path.

Port of tpu_llama/runtime/scheduler.py.  The reference runs one request at
a time (llama2.ts:460-511); this scheduler multiplexes many requests over
the engine's KV-cache slots with in-flight join and leave:

* requests queue, then admit into free slots through one batched compact
  prefill;
* every tick decodes ALL active slots in one engine call;
* sampling is host-side per request with the request's own xorshift64*
  stream and the reference's exact sampler semantics;
* a request retires on BOS (llama2.ts:499), a stop token or its step
  budget, and its slot is reusable at once.

Generation semantics mirror the reference: the fed sequence is [BOS] +
prompt, ``steps`` counts total positions (clamped to seq_len,
llama2.ts:439).  Device sampling and prefix reuse come with a later slice
(ROADMAP) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable

import numpy as np

from tpu_llama_torch.compat.rng import Xorshift64Star
from tpu_llama_torch.compat.sampling import argmax, sample, sample_topp
from tpu_llama_torch.io.tokenizer import BOS
from tpu_llama_torch.runtime.engine import Engine


@dataclasses.dataclass
class Request:
    prompt_tokens: list[int]  # WITHOUT the leading BOS (added internally)
    steps: int = 256  # total positions incl. prompt (reference -n semantics)
    temperature: float = 1.0
    topp: float = 1.0
    seed: int = 1
    on_token: Callable[[int], None] | None = None
    # True -> sample on the device: not ported yet (ROADMAP, next slice 2)
    device_sampling: bool = False
    # Extra stop token ids beyond the reference's BOS rule, e.g. (2,).  The
    # stop token itself is not emitted.
    stop_tokens: tuple = ()
    # >0: record the chosen token's logprob and the top-N alternatives
    logprobs: int = 0
    priority: int = 0  # lower = more urgent, for policy="priority"

    # filled by the scheduler
    id: int = -1
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    out_logprobs: list[float] = dataclasses.field(default_factory=list)
    out_top_logprobs: list[list] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    done: bool = False

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.submit_time if self.first_token_time else 0.0


@dataclasses.dataclass
class _Active:
    req: Request
    rng: Xorshift64Star
    last_token: int  # token to feed next
    pos: int  # position to feed it at
    budget: int  # remaining forward steps


def _scale_softmax_f32(logits: np.ndarray, temperature: float) -> np.ndarray:
    # Reference logit pipeline: f32-stored division + softmax (llama2.ts:481-485).
    scaled = (logits.astype(np.float64) / temperature).astype(np.float32)
    m = np.max(scaled)
    e = np.exp(scaled.astype(np.float64) - np.float64(m)).astype(np.float32)
    return (e.astype(np.float64) / float(np.sum(e.astype(np.float64)))).astype(np.float32)


def _select_token(logits: np.ndarray, req: Request, rng: Xorshift64Star) -> int:
    if req.temperature == 0.0:
        return argmax(logits)
    probs = _scale_softmax_f32(logits, req.temperature)
    if req.topp <= 0 or req.topp >= 1:
        return sample(probs, rng)
    return sample_topp(probs, req.topp, rng)


def _record_logprobs(logits: np.ndarray, token: int, req: Request) -> None:
    """Append the chosen token's logprob (+ top-N alternatives) from the raw
    (untempered) logits."""
    x = logits.astype(np.float64)
    m = x.max()
    logp = x - (m + np.log(np.exp(x - m).sum()))
    req.out_logprobs.append(float(logp[token]))
    n = req.logprobs
    top = np.argpartition(-logp, min(n, len(logp) - 1))[:n]
    top = top[np.argsort(-logp[top])]
    req.out_top_logprobs.append([(int(t), float(logp[t])) for t in top])


class ContinuousBatcher:
    def __init__(self, engine: Engine, seq_len: int | None = None,
                 prefix_cache_size: int = 0, policy: str = "fifo", aging_s: float = 10.0):
        if policy not in ("fifo", "priority"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        if prefix_cache_size > 0:
            raise NotImplementedError("prefix reuse: ROADMAP, next slice 2")
        # "fifo": arrival order.  "priority": lower Request.priority admits
        # first, with aging (effective priority drops by 1 per ``aging_s``
        # seconds waited) so low-priority work cannot starve.
        self.policy = policy
        self.aging_s = aging_s
        self.engine = engine
        self.seq_len = seq_len or engine.seq_len
        self.queue: deque[Request] = deque()
        self.slots: list[_Active | None] = [None] * engine.max_batch
        self._ids = itertools.count()
        self.finished: list[Request] = []
        # wall-time attribution per phase (seconds)
        self.timers = {"admit": 0.0, "decode": 0.0, "emit": 0.0, "admits": 0,
                       "admitted": 0, "decode_steps": 0}

    # ---- public API ----
    def submit(self, req: Request) -> int:
        if req.device_sampling:
            raise NotImplementedError("device sampling: ROADMAP, next slice 2")
        req.id = next(self._ids)
        req.submit_time = time.time()
        self.queue.append(req)
        return req.id

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_active == 0

    def run(self) -> list[Request]:
        """Drive until everything queued has finished."""
        while not self.idle:
            self.step()
        return self.finished

    def step(self) -> None:
        """One tick: admit into free slots, then decode every active slot."""
        self._admit()
        self._decode_tick()

    def _steps(self, req: Request) -> int:
        steps = req.steps
        return self.seq_len if steps <= 0 or steps > self.seq_len else steps  # llama2.ts:439

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return
        t0 = time.time()
        batch: list[tuple[int, Request]] = []
        while free and self.queue:
            idx = self._next_request_index()
            if not self.engine.can_admit(self._steps(self.queue[idx])):
                break
            req = self.queue[idx]
            del self.queue[idx]
            batch.append((free.pop(0), req))
        if not batch:
            return

        prompts, actives = [], []
        for _, req in batch:
            steps = self._steps(req)
            seq = [BOS] + list(req.prompt_tokens)
            # The reference forwards prompt tokens one by one, consuming the
            # step budget (llama2.ts:465-474): clamp the prefill to it.
            n_forward = min(len(seq), steps)
            prompts.append(seq[:n_forward])
            actives.append(_Active(req=req, rng=Xorshift64Star(req.seed),
                                   last_token=seq[n_forward - 1], pos=n_forward - 1,
                                   budget=steps - n_forward))
        logits = self.engine.prefill(prompts, [slot for slot, _ in batch],
                                     reserve_tokens=[self._steps(r) for _, r in batch])
        self.timers["admit"] += time.time() - t0
        self.timers["admits"] += 1
        self.timers["admitted"] += len(batch)
        for (slot, req), active, row in zip(batch, actives, logits):
            self.slots[slot] = active
            # A budget that truncated the prompt emits nothing new (the
            # reference keeps teacher-forcing until steps run out); otherwise
            # the final prompt position's logits yield one token (llama2.ts
            # :476-503) even when the budget is now 0.
            if active.pos + 1 < len(req.prompt_tokens) + 1:
                self._retire(slot, active)
                continue
            self._emit(slot, active, _select_token(row, req, active.rng), row)

    def _next_request_index(self) -> int:
        if self.policy == "fifo":
            return 0
        now = time.time()

        def eff(r: Request) -> float:
            return r.priority - (now - r.submit_time) / self.aging_s

        return min(range(len(self.queue)), key=lambda i: (eff(self.queue[i]), i))

    def _decode_tick(self) -> None:
        active_slots = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_slots:
            return
        B = self.engine.max_batch
        tokens = np.zeros(B, np.int64)
        pos = np.zeros(B, np.int64)
        for i in active_slots:
            a = self.slots[i]
            tokens[i] = a.last_token
            pos[i] = a.pos + 1
        t0 = time.time()
        logits = self.engine.decode(tokens, pos)
        t1 = time.time()
        for i in active_slots:
            a = self.slots[i]
            a.pos += 1
            a.budget -= 1
            self._emit(i, a, _select_token(logits[i], a.req, a.rng), logits[i])
        self.timers["decode"] += t1 - t0
        self.timers["emit"] += time.time() - t1
        self.timers["decode_steps"] += 1

    def _emit(self, slot: int, a: _Active, token: int, logits=None) -> None:
        if token == BOS or token in a.req.stop_tokens:  # llama2.ts:499 (+opt)
            self._retire(slot, a)
            return
        if not a.req.first_token_time:
            a.req.first_token_time = time.time()
        a.req.out_tokens.append(token)
        if a.req.logprobs > 0 and logits is not None:
            _record_logprobs(np.asarray(logits), token, a.req)
        if a.req.on_token is not None:
            a.req.on_token(token)
        a.last_token = token
        if a.budget <= 0 or a.pos + 1 >= self.seq_len:
            self._retire(slot, a)

    def _retire(self, slot: int, a: _Active) -> None:
        a.req.done = True
        a.req.finish_time = time.time()
        self.finished.append(a.req)
        if self.slots[slot] is a:
            self.slots[slot] = None
            self.engine.release_slot(slot)

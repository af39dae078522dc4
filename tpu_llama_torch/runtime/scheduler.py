"""Continuous-batching scheduler.

Port of tpu_llama/runtime/scheduler.py, on the dense and the paged
layouts.  The reference runs one request at a time (llama2.ts:460-511);
this scheduler multiplexes many requests over the engine's KV-cache slots
with in-flight join and leave:

* requests queue, then admit into free slots through one batched compact
  prefill; on a paged engine a request waits while the pool cannot hold its
  whole step budget beside the requests admitted with it (``can_admit``);
  with ``prefix_cache_size > 0`` a request whose fed sequence starts with a
  cached prefix restores that prefix (rows, or pinned pages) and prefills
  only its suffix (one batched ``prefill_continue``), or no prefill at all
  when the whole sequence was cached; a paged pool that cannot spare a
  snapshot's boundary page caches nothing;
* every tick decodes ALL active slots in one engine call;
* host sampling (the default) is per request with the request's own
  xorshift64* stream and the reference's exact sampler semantics;
  ``Request(device_sampling=True)`` samples on the card with JAX's threefry
  keys, fold_in(key(seed), position), so its tokens equal the JAX engine's;
* when every active request samples on the card, ``step()`` dispatches a
  chunk of up to ``max_chunk`` decode + sample steps, admits queued requests
  while the chunk runs (into free slots and slots that retire inside it),
  then reads the chunk's tokens back;
* a request retires on BOS (llama2.ts:499), a stop token or its step
  budget, and its slot is reusable at once.

Generation semantics mirror the reference: the fed sequence is [BOS] +
prompt, ``steps`` counts total positions (clamped to seq_len,
llama2.ts:439).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from tpu_llama_torch.compat.rng import Xorshift64Star
from tpu_llama_torch.compat.sampling import argmax, sample, sample_topp, scale_softmax_f32
from tpu_llama_torch.io.tokenizer import BOS
from tpu_llama_torch.ops.sampling import fold_in, keys_numpy
from tpu_llama_torch.runtime.engine import Engine


@dataclasses.dataclass
class Request:
    prompt_tokens: list[int]  # WITHOUT the leading BOS (added internally)
    steps: int = 256  # total positions incl. prompt (reference -n semantics)
    temperature: float = 1.0
    topp: float = 1.0
    seed: int = 1
    on_token: Callable[[int], None] | None = None
    # True -> sample on the device (JAX's threefry streams: equal to the JAX
    # engine's tokens, NOT xorshift64*-compatible); False -> host sampling
    device_sampling: bool = False
    topk: int = 0  # top-k filter of device sampling (0 = off)
    # Extra stop token ids beyond the reference's BOS rule, e.g. (2,).  The
    # stop token itself is not emitted.
    stop_tokens: tuple = ()
    # >0: record the chosen token's logprob and the top-N alternatives
    # (forces the host-logits decode path)
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


def _select_token(logits: np.ndarray, req: Request, rng: Xorshift64Star) -> int:
    if req.temperature == 0.0:
        return argmax(logits)
    probs = scale_softmax_f32(logits, req.temperature)
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


def _host(row) -> np.ndarray:
    return row.cpu().numpy() if isinstance(row, torch.Tensor) else np.asarray(row)


def _on_device(a: _Active) -> bool:
    return a.req.device_sampling and a.req.logprobs == 0


class _Readback:
    """A device tensor's copy to the host, queued now and awaited later.  A
    blocking ``.cpu()`` would wait for everything queued on the stream
    since, an overlapped admission's prefill included; this waits only for
    the work queued before it."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host, self.done = t, None

    def numpy(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


class ContinuousBatcher:
    def __init__(self, engine: Engine, seq_len: int | None = None, max_chunk: int = 1,
                 prefix_cache_size: int = 0, policy: str = "fifo", aging_s: float = 10.0):
        if policy not in ("fifo", "priority"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
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
        # >1: device-sampled batches decode in chunks of up to this many
        # steps per dispatch; stop conditions apply per emitted token
        self.max_chunk = max_chunk
        # up to this many prompt-KV snapshots keyed by their fed token tuple,
        # least recently used first
        self.prefix_cache_size = prefix_cache_size
        self._prefix: dict[tuple, dict] = {}  # seq tuple -> {snap, logits}
        self.prefix_hits = 0
        # wall-time attribution per phase (seconds): decode is every decode
        # call's host time (a chunk's dispatch plus its read), decode_steps
        # the steps decoded (k per chunk)
        self.timers = {"admit": 0.0, "decode": 0.0, "decode_dispatch": 0.0,
                       "decode_read": 0.0, "emit": 0.0, "chunks": 0, "chunk_steps": 0,
                       "admits": 0, "admitted": 0, "decode_steps": 0}

    # ---- public API ----
    def submit(self, req: Request) -> int:
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
        """One tick: decode dispatch -> overlapped admission -> readback
        (scheduler.py:178-200).  The all-device chunk path queues the chunk
        without waiting, then admits into free slots and into slots whose
        remaining budget retires them inside the chunk (budget <= k;
        BOS or a stop token only retire earlier), then reads the chunk.
        The card runs chunk and admission back to back; the admission's
        writes into a re-admitted slot queue after the chunk's overshoot
        writes there.  Other paths admit, then decode."""
        pending = self._decode_dispatch_fast()
        if pending is not None:
            self._admit(retiring=[s for s, a in pending["actives"].items()
                                  if a.budget <= pending["k"]])
            self._decode_finish(pending)
        else:
            self._admit()
            self._decode_tick()

    def _steps(self, req: Request) -> int:
        steps = req.steps
        return self.seq_len if steps <= 0 or steps > self.seq_len else steps  # llama2.ts:439

    def _admit(self, retiring: Sequence[int] = ()) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        free += [i for i in retiring if i not in free]
        if not free or not self.queue:
            return
        t0 = time.time()
        batch: list[tuple[int, Request]] = []
        claimed: list[int] = []  # the positions the batch reserves so far
        while free and self.queue:
            idx = self._next_request_index()
            steps = self._steps(self.queue[idx])
            # backpressure (paged KV): a request reserves pages for its whole
            # step budget; if the pool cannot hold it beside the batch so
            # far, it waits
            if not self.engine.can_admit(steps, claimed):
                break
            claimed.append(steps)
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
        slot_ids = [slot for slot, _ in batch]

        last_logits: list = [None] * len(batch)
        hits, misses = [], []
        for i, p in enumerate(prompts):
            key = self._best_prefix(tuple(p))
            (hits if key is not None else misses).append((i, key))
        if misses:
            # the logits stay on the card: device-sampled rows never come back
            logits = self.engine.prefill(
                [prompts[i] for i, _ in misses], [slot_ids[i] for i, _ in misses],
                reserve_tokens=[self._steps(batch[i][1]) for i, _ in misses],
                return_device=True)
            for j, (i, _) in enumerate(misses):
                last_logits[i] = logits[j]
                if self.prefix_cache_size > 0:
                    self._store_prefix(tuple(prompts[i]), slot_ids[i], logits[j])
        # restore every hit, then one batched continuation for the partial ones
        continuations = []
        for i, key in hits:
            self.prefix_hits += 1
            entry = self._prefix[key]
            self._prefix[key] = self._prefix.pop(key)  # LRU touch
            self.engine.restore_slot(slot_ids[i], entry["snap"],
                                     reserve_tokens=self._steps(batch[i][1]))
            if len(key) == len(prompts[i]):
                last_logits[i] = entry["logits"]  # the whole prompt was cached
            else:
                continuations.append((i, key))
        if continuations:
            logits = self.engine.prefill_continue(
                [prompts[i][len(key):] for i, key in continuations],
                [slot_ids[i] for i, _ in continuations],
                [len(key) for _, key in continuations], return_device=True)
            for (i, _), row in zip(continuations, logits):
                last_logits[i] = row

        # first tokens: device-sampled requests sample on the card with the
        # decode chunks' key derivation, folding in the last prompt position
        dev = [i for i, a in enumerate(actives)
               if _on_device(a) and a.pos + 1 >= len(a.req.prompt_tokens) + 1]
        first_tok = {}
        if dev:
            reqs = [actives[i].req for i in dev]
            toks = self.engine.sample_logits(
                [last_logits[i] for i in dev],
                np.array([r.temperature for r in reqs], np.float32),
                np.array([r.topp for r in reqs], np.float32),
                np.array([r.topk for r in reqs], np.int64),
                keys_numpy([r.seed for r in reqs]),
                np.array([actives[i].pos for i in dev], np.int64))
            first_tok = {i: int(t) for i, t in zip(dev, toks)}

        self.timers["admit"] += time.time() - t0
        self.timers["admits"] += 1
        self.timers["admitted"] += len(batch)
        for j, ((slot, req), active) in enumerate(zip(batch, actives)):
            self.slots[slot] = active
            # A budget that truncated the prompt emits nothing new (the
            # reference keeps teacher-forcing until steps run out); otherwise
            # the final prompt position's logits yield one token (llama2.ts
            # :476-503) even when the budget is now 0.
            if active.pos + 1 < len(req.prompt_tokens) + 1:
                self._retire(slot, active)
            elif j in first_tok:
                self._emit(slot, active, first_tok[j])
            else:
                row = _host(last_logits[j])
                self._emit(slot, active, _select_token(row, req, active.rng), row)

    def _next_request_index(self) -> int:
        if self.policy == "fifo":
            return 0
        now = time.time()

        def eff(r: Request) -> float:
            return r.priority - (now - r.submit_time) / self.aging_s

        return min(range(len(self.queue)), key=lambda i: (eff(self.queue[i]), i))

    # ---- prefix cache (scheduler.py:358-381) ----
    def _best_prefix(self, seq: tuple) -> tuple | None:
        """The longest cached prefix of ``seq`` (``seq`` itself included)."""
        if self.prefix_cache_size <= 0:
            return None
        best = None
        for key in self._prefix:
            if len(key) <= len(seq) and seq[:len(key)] == key and (
                    best is None or len(key) > len(best)):
                best = key
        return best

    def _store_prefix(self, seq: tuple, slot: int, logits) -> None:
        if seq in self._prefix:
            return
        snap = self.engine.snapshot_slot(slot, len(seq))
        if snap is None:  # a paged pool that cannot spare the boundary page
            return
        self._prefix[seq] = {"snap": snap, "logits": logits.clone()}
        while len(self._prefix) > self.prefix_cache_size:
            evicted = self._prefix.pop(next(iter(self._prefix)))  # least recently used
            self.engine.release_snapshot(evicted["snap"])

    # ---- decode ----
    def _chunk_size(self, active_slots, round_up: bool) -> int:
        """The power-of-two chunk: capped by max_chunk, by every slot's room
        left in the cache (no row at or past seq_len) and by the largest
        remaining budget, not the smallest (scheduler.py:409-416, 512-516)."""
        min_cap = min(self.seq_len - 1 - self.slots[i].pos for i in active_slots)
        max_budget = max(self.slots[i].budget for i in active_slots)
        lim = min(self.max_chunk, max(1, min_cap), max(1, max_budget))
        k = 1 << (lim.bit_length() - 1)
        # the dispatch's retire-in-chunk round-up: when the next power of two
        # covers every remaining budget with at most 2 wasted steps (and fits
        # the caps), the batch retires inside the chunk and the queue admits
        # under it
        if (round_up and self.queue and (max_budget > k or k == 1)
                and 2 * k - max_budget <= 2 and 2 * k <= min(self.max_chunk, max(1, min_cap))):
            k *= 2
        return k

    def _sampling_rows(self):
        """Per-slot (tokens, pos, temperatures, top-p, top-k, base keys) of
        the full slot batch; idle slots feed token 0 at position 0, greedy."""
        B = self.engine.max_batch
        tokens, pos, topks = (np.zeros(B, np.int64) for _ in range(3))
        temps, topps = np.zeros(B, np.float32), np.ones(B, np.float32)
        seeds = [0] * B
        for i, a in enumerate(self.slots):
            if a is not None:
                tokens[i], pos[i] = a.last_token, a.pos + 1
                temps[i], topps[i], topks[i] = a.req.temperature, a.req.topp, a.req.topk
                seeds[i] = a.req.seed
        return tokens, pos, temps, topps, topks, keys_numpy(seeds)

    def _decode_dispatch_fast(self):
        """Queue the all-device decode chunk WITHOUT reading it back
        (scheduler.py:383-451).  Returns {"actives", "k", "read"} with the
        chunk in flight, or None when the chunk path does not apply (no
        actives, a host-sampled or logprobs request, or k == 1).

        OVERLAP INVARIANT: a retiring slot keeps decoding to the chunk's end,
        and the deferred K10 flush writes its rows past its stop.  That is
        safe because every write of the admission that follows (K7, a
        restore, a continuation's write-back) is queued on the same stream
        after the chunk, and decode reads only rows below pos plus its own
        fresh row.  Do not move cache writes to another stream."""
        active_slots = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_slots or not all(_on_device(self.slots[i]) for i in active_slots):
            return None
        k = self._chunk_size(active_slots, round_up=True)
        if k <= 1:
            return None
        tokens, pos, temps, topps, topks, keys = self._sampling_rows()
        t0 = time.time()
        chunk = self.engine.decode_sample_chunk_async(tokens, pos, temps, topps, keys, k,
                                                      topks=topks)
        read = _Readback(chunk)
        dt = time.time() - t0
        self.timers["decode_dispatch"] += dt
        self.timers["decode"] += dt
        self.timers["chunks"] += 1
        self.timers["chunk_steps"] += k
        self.timers["decode_steps"] += k
        return {"actives": {i: self.slots[i] for i in active_slots}, "k": k, "read": read}

    def _decode_finish(self, pending) -> None:
        """Read the chunk and emit its tokens against the actives captured at
        dispatch (their slots may hold new requests by now)."""
        t0 = time.time()
        chunk = pending["read"].numpy()
        dt = time.time() - t0
        self.timers["decode_read"] += dt
        self.timers["decode"] += dt
        t0 = time.time()
        for i, a in pending["actives"].items():
            for j in range(pending["k"]):
                if a.req.done:
                    break  # retired mid-chunk (BOS, stop token or budget)
                a.pos += 1
                a.budget -= 1
                self._emit(i, a, int(chunk[i, j]))
        self.timers["emit"] += time.time() - t0

    def _advance(self, active_slots, tokens_of) -> None:
        t0 = time.time()
        for i in active_slots:
            a = self.slots[i]
            a.pos += 1
            a.budget -= 1
            self._emit(i, a, *tokens_of(i, a))
        self.timers["emit"] += time.time() - t0

    def _decode_tick(self) -> None:
        """One decode step, or one blocking chunk (scheduler.py:470-572)."""
        active_slots = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_slots:
            return
        tokens, pos, temps, topps, topks, keys = self._sampling_rows()
        eng = self.engine
        t0 = time.time()
        if all(_on_device(self.slots[i]) for i in active_slots):
            k = self._chunk_size(active_slots, round_up=False)
            if k > 1:
                chunk = eng.decode_sample_chunk(tokens, pos, temps, topps, keys, k, topks=topks)
                self.timers["decode"] += time.time() - t0
                self.timers["decode_steps"] += k
                t0 = time.time()
                for i in active_slots:
                    a = self.slots[i]
                    for j in range(k):
                        if self.slots[i] is not a or a.req.done:
                            break  # retired mid-chunk (BOS or budget)
                        a.pos += 1
                        a.budget -= 1
                        self._emit(i, a, int(chunk[i, j]))
                self.timers["emit"] += time.time() - t0
                return
            step_keys = fold_in(torch.from_numpy(keys), torch.from_numpy(pos))
            nxt = eng.decode_sample(tokens, pos, temps, topps, step_keys, topks=topks)
            self.timers["decode"] += time.time() - t0
            self.timers["decode_steps"] += 1
            self._advance(active_slots, lambda i, a: (int(nxt[i]),))
            return
        logits_dev = eng.decode(tokens, pos, return_device=True)
        # mixed batch: the device-sampled slots share one sample call with
        # the all-device path's key derivation, so a request's stream does
        # not depend on what it is batched with
        dev = [i for i in active_slots if self.slots[i].req.device_sampling]
        dev_tok = {}
        if dev:
            ix = np.array(dev)
            nxt = eng.sample_logits([logits_dev[i] for i in dev], temps[ix], topps[ix],
                                    topks[ix], keys[ix], pos[ix])
            dev_tok = {i: int(t) for i, t in zip(dev, nxt)}
        logits = logits_dev.cpu().numpy()
        self.timers["decode"] += time.time() - t0
        self.timers["decode_steps"] += 1

        def token(i, a):
            nxt = dev_tok.get(i)
            return (_select_token(logits[i], a.req, a.rng) if nxt is None else nxt), logits[i]

        self._advance(active_slots, token)

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
        if self.slots[slot] is a:  # an overlapped admission may hold the slot already
            self.slots[slot] = None
            self.engine.release_slot(slot)

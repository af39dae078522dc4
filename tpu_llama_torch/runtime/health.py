"""Failure detection + crash recovery (SURVEY §5.3).

Port of tpu_llama/runtime/health.py on the port's ``Request`` (host code).

The reference's failure handling is `throw` + `process.exit(1)`
(llama2.ts:310, 523).  Serving needs two minimum-viable mechanisms:

* ``Watchdog`` -- liveness monitor: the scheduler loop calls ``beat()`` every
  tick; a background thread fires ``on_stall`` if beats stop (hung device,
  wedged collective).  On multi-host deployments each host runs one and
  aborts the process so its ``torch.distributed`` peers fail fast instead
  of deadlocking in a collective.
* ``RequestLog`` -- a durable journal of submitted/completed requests.  After
  a crash, ``replay_incomplete()`` yields the requests that never finished so
  a fresh process re-serves them (generation restarts from pos 0 -- KV state
  is reconstructable from the log by design).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Callable

from tpu_llama_torch.runtime.scheduler import Request


class Watchdog:
    def __init__(self, threshold_s: float = 60.0,
                 on_stall: Callable[[], None] | None = None,
                 poll_s: float | None = None):
        self.threshold_s = threshold_s
        self.on_stall = on_stall or self._default_stall
        self._last = time.monotonic()
        self._active = False
        self._stop = threading.Event()
        self._fired = False
        self._poll_s = poll_s if poll_s is not None else min(1.0, threshold_s / 4)
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "Watchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def beat(self, active: bool = True) -> None:
        """Call from the scheduler loop each tick.  ``active=False`` marks
        idle (no work in flight -> no stall possible)."""
        self._last = time.monotonic()
        self._active = active

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            if self._active and time.monotonic() - self._last > self.threshold_s:
                self._fired = True
                self.on_stall()
                return

    @staticmethod
    def _default_stall() -> None:
        # Abort hard: on a pod slice a wedged host must die, not hang peers.
        import sys

        print("tpu_llama_torch watchdog: scheduler stalled -- aborting", file=sys.stderr)
        os._exit(42)


class RequestLog:
    """Append-only JSONL journal: 'submit' and 'done' records per request."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()

    def log_submit(self, req: Request) -> None:
        rec = {
            "type": "submit", "id": req.id,
            "prompt_tokens": list(req.prompt_tokens), "steps": req.steps,
            "temperature": req.temperature, "topp": req.topp, "seed": req.seed,
            # sampling/stop semantics must replay exactly (ADVICE r1)
            "device_sampling": req.device_sampling, "topk": req.topk,
            "stop_tokens": list(req.stop_tokens),
        }
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")

    def log_done(self, req: Request) -> None:
        with self._lock:
            self._f.write(json.dumps(
                {"type": "done", "id": req.id,
                 "out_tokens": list(req.out_tokens)}) + "\n")

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def replay_incomplete(path: str | os.PathLike) -> list[Request]:
        """Requests submitted but never completed (crash recovery)."""
        submitted: dict[int, dict] = {}
        done: set[int] = set()
        p = Path(path)
        if not p.exists():
            return []
        for line in p.read_text().splitlines():
            if not line.strip():
                continue
            rec = json.loads(line)
            if rec["type"] == "submit":
                submitted[rec["id"]] = rec
            elif rec["type"] == "done":
                done.add(rec["id"])
        out = []
        for rid, rec in sorted(submitted.items()):
            if rid not in done:
                out.append(Request(
                    prompt_tokens=rec["prompt_tokens"], steps=rec["steps"],
                    temperature=rec["temperature"], topp=rec["topp"],
                    seed=rec["seed"],
                    device_sampling=rec.get("device_sampling", False),
                    topk=rec.get("topk", 0),
                    stop_tokens=tuple(rec.get("stop_tokens", ())),
                ))
        return out

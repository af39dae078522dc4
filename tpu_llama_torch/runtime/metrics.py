"""Serving metrics: TTFT, throughput, batch occupancy.

A copy of tpu_llama/runtime/metrics.py.  The reference's observability is a
single end-of-run tok/s line (llama2.ts:510-511); this module aggregates
per-request timings from the scheduler into p50/p95 TTFT and tokens/s
(total and per request) as JSONL-able dicts.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

from tpu_llama_torch.runtime.scheduler import Request


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


@dataclasses.dataclass
class ServingReport:
    n_requests: int
    total_tokens: int
    wall_s: float
    tokens_per_sec: float
    ttft_p50_s: float
    ttft_p95_s: float
    per_request_tps_p50: float

    def json_line(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def summarize(requests: Sequence[Request]) -> ServingReport:
    done = [r for r in requests if r.done and r.finish_time]
    if not done:
        return ServingReport(0, 0, 0.0, 0.0, 0.0, 0.0, 0.0)
    t0 = min(r.submit_time for r in done)
    t1 = max(r.finish_time for r in done)
    total = sum(len(r.out_tokens) for r in done)
    ttfts = [r.ttft for r in done if r.first_token_time]
    per_tps = [
        len(r.out_tokens) / max(r.finish_time - r.submit_time, 1e-9) for r in done
    ]
    return ServingReport(
        n_requests=len(done),
        total_tokens=total,
        wall_s=t1 - t0,
        tokens_per_sec=total / max(t1 - t0, 1e-9),
        ttft_p50_s=_pct(ttfts, 50),
        ttft_p95_s=_pct(ttfts, 95),
        per_request_tps_p50=_pct(per_tps, 50),
    )

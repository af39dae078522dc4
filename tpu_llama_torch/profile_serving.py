"""Where the time of the 7B serving path goes on the card.

Run from the repo root on a machine with a CUDA card:

    python3 -m tpu_llama_torch.profile_serving

Builds random W8A8 weights at Llama-2 7B width in the fused wqkv / w13
layouts (``random_quant_params(fuse=True)``, the served path) and an
``Engine(max_batch=8, INT8 dense KV, seq_len=2048)``, warms it up, then
traces with ``torch.profiler`` (a) one admission of 8 prompts of 512 tokens
(the fused prefill body: K3, K4, K5 and the residual K1) and the same
admission on unfused weights of the same shapes, (b) 8 decode steps of all 8
slots at position 512 with each decode attention (``"flash_dma"`` K9,
``"flash"`` K19, ``"xla"``; the first line names what ``"auto"`` resolves
to) and with K9 on the unfused weights, then (c) 8 decode steps of a
one-slot engine at position 512 with K19 and with K9 -- the A/B behind
``"auto"``.  All go through the engine calls the scheduler makes.  Each phase runs warm, then
once timed and once traced.  Prints one JSON line per phase: host wall
time of the untraced and the traced run (closed by
``torch.cuda.synchronize``), device busy time (the union of kernel
intervals in the trace), the device's idle share against the untraced
wall, device time per port kernel and for everything else, the top kernels
by device time, and each port kernel's launch count in the untraced run.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

DECODE_STEPS = 8
PORT_KERNELS = {"w8a8_kernel": "K1", "quantize_rows_kernel": "K2",
                "rmsnorm_quantize_kernel": "K3", "silu_mul_quantize_kernel": "K4",
                "rope_split_quantize_kernel": "K5", "flash_prefill_kernel": "K6",
                "kv_scatter_kernel": "K7", "flash_decode_dma_kernel": "K9",
                "kv_flush_rows_kernel": "K10", "flash_decode_fresh_kernel": "K19"}


def _kernel_events(prof):
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _busy_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted((s, e) for _, s, e in intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(name: str, prof, wall_s: float, traced_wall_s: float, smi: str) -> dict:
    """``wall_s`` is an untraced run's host time, ``traced_wall_s`` the
    traced run's (the tracer adds host time per launch, so the idle share
    is taken against the untraced wall)."""
    ev = _kernel_events(prof)
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for n, s, e in ev:
        group = next((k for sub, k in PORT_KERNELS.items() if sub in n), "other")
        by_group[group] = by_group.get(group, 0.0) + (e - s) / 1e3
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e3
    busy_ms = _busy_us(ev) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(phase=name, wall_ms=wall_s * 1e3, traced_wall_ms=traced_wall_s * 1e3,
                device_busy_ms=busy_ms,
                idle_share=max(0.0, 1 - busy_ms / (wall_s * 1e3)) if ev else None,
                n_kernels=len(ev), device_ms=by_group,
                top=[(n[:90], ms) for n, ms in top], card=smi)


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models.llama import random_quant_params
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LLAMA2_7B
    params = random_quant_params(cfg, seed=0, fuse=True)
    engine = Engine(params, cfg, max_batch=8, seq_len=2048)
    rng = np.random.default_rng(0)
    prompts = [[1] + [int(t) for t in rng.integers(3, cfg.vocab_size, 511)]
               for _ in range(8)]
    toks = rng.integers(3, cfg.vocab_size, 8)

    def prefiller(eng):
        return lambda: eng.prefill(prompts, list(range(8)))

    def decoder(eng):
        b = eng.max_batch

        def decode():
            for i in range(DECODE_STEPS):
                eng.decode(toks[:b], np.full(b, 512 + i))
        return decode

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def run(phase, fn, **extra):
        timed(fn)  # warm: builds the kernels, fills the allocator
        _kernels.reset_counts()
        wall = timed(fn)
        launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced = timed(fn)
        print(json.dumps(dict(summarize(phase, prof, wall, traced, smi), **extra,
                              launches=launches)), flush=True)

    run("prefill_8x512", prefiller(engine), layouts="fused")
    unfused = Engine(random_quant_params(cfg, seed=0), cfg, max_batch=8, seq_len=2048)
    run("prefill_8x512_unfused", prefiller(unfused), layouts="unfused")
    run(f"decode_b8_x{DECODE_STEPS}_flash_dma_unfused", decoder(unfused), attn="flash_dma",
        layouts="unfused")
    del unfused
    torch.cuda.empty_cache()
    one = Engine(params, cfg, max_batch=1, seq_len=2048)
    one.prefill([prompts[0]], [0])
    for eng, attns in ((engine, ("flash_dma", "flash", "xla")), (one, ("flash", "flash_dma"))):
        auto = eng.decode_attn  # the engines were built with attn="auto"
        for attn in attns:
            eng.decode_attn = attn
            run(f"decode_b{eng.max_batch}_x{DECODE_STEPS}_{attn}", decoder(eng),
                attn=attn, auto_resolves_to=auto)
    print(json.dumps(dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          layers=cfg.n_layers, card=smi)))


if __name__ == "__main__":
    main()

"""Where the time of the 7B serving path goes on the card.

Run from the repo root on a machine with a CUDA card:

    python3 -m tpu_llama_torch.profile_serving

Builds random W8A8 weights at Llama-2 7B width in the fused wqkv / w13
layouts (``random_quant_params(fuse=True)``, the served path) and an
``Engine(max_batch=8, INT8 dense KV, seq_len=2048)``, warms it up, then
traces with ``torch.profiler`` (a) one admission of 8 prompts of 512 tokens
(the fused prefill body: K3, K4, K5 and the residual K1) and the same
admission on unfused weights of the same shapes, each run warm, then once
timed and once traced; (b) the decode A/B behind ``forward_decode``'s
``fused="auto"``: 8 decode steps of all 8 slots at position 512, and of a
one-slot engine at position 512, with each of the unfused decode (K9 per
layer, ``fused=False``), the two-launch decode (K11 + K9, ``True``), mega2
(K12, ``"mega2"``) and the opt-in mega3 (K26, ``"mega3"``) and mega (K27,
``"mega"``), decode attention K9 throughout.  The host wall per step of the
five modes is taken over three interleaved repetitions (mode 1, 2, ..., 5,
1, 2, ...), then each mode is traced once.  All go
through the engine calls the scheduler makes.  Prints one JSON line per
phase: host wall time of the untraced runs and of the traced run (closed by
``torch.cuda.synchronize``), device busy time (the union of kernel intervals
in the trace), the device's idle share against the untraced wall, device
time per port kernel and for everything else (``device_ms["other"]``: the
plain PyTorch operations), the top kernels by device time, and each port
kernel's launch count in an untraced run.  K1 and K8 run the same CUDA
kernels (K8 is K1's on a layer view: its decode tile up to 16 rows, its
wgmma kernel above), so the trace reports their device time together, as
"K1+K8".  Then (c) the long-prompt path: one admission of 8
prompts of 2048 tokens (16 384 rows: the chunked prefill, 8 chunks of 256,
K18 landing each chunk) and one device-sampled decode chunk of 16 steps of
all 8 slots at position 1024 (``decode_sample_chunk``: mega2 decode plus
the threefry sampler, the scheduler's ``max_chunk=16`` path).  (e) the
paged INT8 path on the same weights (``Engine(kv_layout="paged",
page_size=512)``): one compact admission of 8 prompts of 512 tokens (the
fused prefill body, then K15 landing the block in the pool) and one decode
step of all 8 slots at position 512 with ``fused="auto"`` (the two-launch
K11 decode with K13) and with ``fused=False`` (the unfused stack with K13),
each timed three times, then traced; one K14 flush per step; then a paged
prefix hit: a 300-row snapshot restored into 5 slots and one continuation of
5 suffixes of 200 tokens.  (f) the pool-direct paged admission (K16 + K17,
``Engine(max_batch=32, kv_layout="paged", page_size=512, num_pages=97)``):
one admission of 8 prompts of 2048 tokens (one wave, 8 chunks of 256) and
one of 32 prompts of 1024 tokens (two waves of 16 slots, 4 chunks each),
with device ms per launch of K16, K17, K1, K3, K4 and K5.  (d) the JAX
server's default model path: random dense f32 weights in the fused layouts
(``random_params`` + ``fuse_projections``) with the default float32 cache,
then the same weights in Q8_0 (``quantize_params``, K25) with a bfloat16
cache, ``Engine(max_batch=8, seq_len=2048)`` at its default precision: one
admission of 8 prompts of 512 tokens and one decode step of all 8 slots at
position 512 on each, traced as above, with each port kernel's device ms per
launch (``ms_per_launch``).  The fp forms of K6, K7, K9 and K10 report under
their kernels' ids (their CUDA kernels are the INT8 forms' templates).
``--fp-only`` runs (d) alone.  ``--decode-only`` runs (g) alone: the
decode steps that K9's and K13's split cell (csrc/decode_split.cuh) serves,
on engines whose caches are left as allocated (a step's time does not
depend on the values it reads): one slot at position 2000 (where the split
rule splits) with the two-launch decode (K11 + K9, ``fused=True``), mega2
(one K9 launch) and on the paged layout (two-launch, K13); all 8 slots at
position 512 on the paged layout (K13, one split) and on the dense f32 and
Q8_0 paths (K9's fp forms, one split); each timed three times, then
traced, with K9's or K13's device ms per step.  ``--mega-steps`` runs (h)
alone: the mega2 (K12) and mega3 (K26) decode steps of an 8-slot engine at
position 512 and a one-slot engine at position 2000, timed and traced as
(g), with K12's or K26's device ms per step, then K12 and K26 alone at
PERF.md's table shapes (events and trace); it calls only the engine's and
the wrappers' public signatures, so ``PYTHONPATH=<other checkout> python3
tpu_llama_torch/profile_serving.py --mega-steps`` times another checkout's
package with this script.  ``--admissions`` runs (i) alone: the 8 x 512,
chunked 8 x 2048 and pool-direct 32 x 1024 W8A8 admissions and the mega2
step of 8 slots at position 512, each timed REPS times and traced, with the
row quants' (K3, K2) device ms; it too calls only public signatures.
``--layer-steps`` runs (j) alone: the streaming body's layer kernels
alone at PERF.md's table shapes -- K11 at batch 8 and 32 on layer 17 and
the last layer, K27 at K12's shapes (its cells at their default splits),
then K12 and K26 as (h) takes them -- events and trace, then the decode
steps that launch K11 and K27 32 times each -- the paged two-launch step
(K13 + K11, ``fused="auto"``) and the mega step (K27) of 8 slots at
position 512 -- and the mega2 step (K12) beside them, each as
``measure_step`` takes it; public signatures only, so it also times another
checkout's package.  ``--tp-spans`` runs (k) alone: K23 and K24 alone at PERF.md's
table shapes (7B's local widths at tp 1 / 2 / 4 / 8, batch 8, and tp 1 at
batch 32), events and trace, then the fused tensor-parallel decode step at
tp = 1 (``Engine(mesh=single_device_mesh(), tp_fused=True)``: phase 4i's
kernels, its collectives the identity) of 8 slots at position 512, as
``measure`` takes it, with the device ms of K23, K24 and the decode's other
kernels; public signatures only, so it also times another checkout's
package.  ``--flush`` runs (l) alone: the flush kernels alone at
chip_smoke.py's shapes (``flush_cases``: K10 INT8, f32 and bf16 on the 7B
cache, K14 at batch 8 and 32 on pools of 512-row pages, K28 INT8), each
with its events and trace device ms, its plain version's, one library
call's and its bytes bound, then the paged two-launch step (K14) and the
mega2 step (K10) of 8 slots at position 512, as ``measure_step`` takes
them; public signatures only, so it also times another checkout's package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

DECODE_STEPS = 8
CHUNK_STEPS = 16
REPS = 3
AB_MODES = (False, True, "mega2", "mega3", "mega")
# kernel name substrings -> port ids; the paged kernels first, as their names
# contain the dense ones'
PORT_KERNELS = {"paged_flash_decode_dma_kernel": "K13", "paged_flash_decode_fresh_kernel": "K20",
                "kv_pool_flush_rows_kernel": "K14", "kv_pool_scatter_kernel": "K15",
                "paged_flash_prefill_kernel": "K16", "kv_pool_write_chunk_kernel": "K17",
                "paged_flash_decode_kernel": "K22",
                "w8a8_kernel": "K1+K8", "w8a8_wgmma_kernel": "K1+K8", "quantize_rows_kernel": "K2",
                "rmsnorm_quantize_kernel": "K3", "silu_mul_quantize_kernel": "K4",
                "rope_split_quantize_kernel": "K5", "flash_prefill_fp_kernel": "K6",
                "flash_prefill_i8_kernel": "K6",
                "kv_scatter_kernel": "K7", "kv_write_chunk_kernel": "K18",
                "flash_decode_dma_kernel": "K9",
                "kv_flush_rows_kernel": "K10", "fused_layer_kernel": "K11",
                "fused_step2_kernel": "K12", "flash_decode_fresh_kernel": "K19",
                "q8_gemv_kernel": "K25", "q8_matmul_wgmma_kernel": "K25",
                "fused_step3_kernel": "K26", "fused_step_kernel": "K27",
                "kv_write_decode_kernel": "K28", "rows_resident_kernel": "K29",
                "flash_decode_simple_kernel": "K21", "flash_decode_blocked_kernel": "K21",
                "fused_ffn_kernel": "K23", "fused_rms_qkv_kernel": "K24"}


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


def _prompts(rng, cfg, n: int, length: int) -> list:
    """``n`` prompts of ``length`` tokens: BOS, then random ids."""
    return [[1] + [int(t) for t in rng.integers(3, cfg.vocab_size, length - 1)] for _ in range(n)]


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


def main(argv=None) -> None:
    import argparse

    from torch.profiler import ProfilerActivity, profile

    from tpu_llama_torch.config import LLAMA2_7B
    from tpu_llama_torch.models.llama import (
        fuse_projections,
        quantize_params,
        random_params,
        random_quant_params,
    )
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.runtime import Engine

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp-only", action="store_true",
                    help="run section (d) alone: the dense f32 and Q8_0 paths")
    ap.add_argument("--decode-only", action="store_true",
                    help="run section (g) alone: the decode steps of K9's and K13's split cell")
    ap.add_argument("--mega-steps", action="store_true",
                    help="run section (h) alone: the mega2 and mega3 decode steps (K12, K26)")
    ap.add_argument("--admissions", action="store_true",
                    help="run section (i) alone: the W8A8 admissions' row quants (K3, K2) and "
                         "the mega2 b8 step")
    ap.add_argument("--layer-steps", action="store_true",
                    help="run section (j) alone: K11, K27, K12 and K26 alone, the paged "
                         "two-launch, mega and mega2 b8 steps")
    ap.add_argument("--tp-spans", action="store_true",
                    help="run section (k) alone: K23 and K24 alone and the fused TP decode step "
                         "at tp = 1")
    ap.add_argument("--flush", action="store_true",
                    help="run section (l) alone: K10, K14 and K28 alone, the paged two-launch "
                         "and mega2 b8 steps")
    args = ap.parse_args(argv)
    fp_only = args.fp_only
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LLAMA2_7B
    if args.decode_only:
        decode_steps(cfg, smi)
        return
    if args.mega_steps:
        mega_steps(cfg, smi)
        return
    if args.admissions:
        admissions(cfg, smi)
        return
    if args.layer_steps:
        layer_steps(cfg, smi)
        return
    if args.tp_spans:
        tp_spans(cfg, smi)
        return
    if args.flush:
        flush_steps(cfg, smi)
        return
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, cfg, 8, 512)
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

    def counted(fn) -> dict:
        _kernels.reset_counts()
        fn()
        torch.cuda.synchronize()
        return {k: n for k, n in _kernels.LAUNCHES.items() if n}

    def traced(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            wall = timed(fn)
        return prof, wall

    def run(phase, fn, per_launch=False, **extra):
        timed(fn)  # warm: builds the kernels, fills the allocator
        launches = counted(fn)
        wall = timed(fn)
        prof, traced_wall = traced(fn)
        line = dict(summarize(phase, prof, wall, traced_wall, smi), **extra, launches=launches)
        if per_launch:  # each port kernel's device ms per launch (an fp form under its id)
            line["ms_per_launch"] = {k: line["device_ms"][k.split(":")[0]] / n
                                     for k, n in launches.items()
                                     if k.split(":")[0] in line["device_ms"]}
        print(json.dumps(line), flush=True)

    if not fp_only:  # the W8A8 engine's sections
        params = random_quant_params(cfg, seed=0, fuse=True)
        engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
        run("prefill_8x512", prefiller(engine), layouts="fused")
        unfused = Engine(random_quant_params(cfg, seed=0), cfg, max_batch=8, kv_dtype="int8",
                         seq_len=2048)
        run("prefill_8x512_unfused", prefiller(unfused), layouts="unfused")
        del unfused
        torch.cuda.empty_cache()
        one = Engine(params, cfg, max_batch=1, kv_dtype="int8", seq_len=2048)
        one.prefill([prompts[0]], [0])
        for eng in (engine, one):
            auto = eng.decode_fused  # the engines were built with fused="auto"
            fn = decoder(eng)
            walls = {m: [] for m in AB_MODES}
            for mode in AB_MODES:  # warm every mode first
                eng.decode_fused = mode
                timed(fn)
            for _ in range(REPS):
                for mode in AB_MODES:
                    eng.decode_fused = mode
                    walls[mode].append(timed(fn) * 1e3 / DECODE_STEPS)
            for mode in AB_MODES:
                eng.decode_fused = mode
                launches = counted(fn)
                prof, traced_wall = traced(fn)
                line = summarize(f"decode_b{eng.max_batch}_x{DECODE_STEPS}_fused_{mode}", prof,
                                 statistics.median(walls[mode]) * DECODE_STEPS / 1e3, traced_wall,
                                 smi)
                line.update(
                    fused=mode, auto_resolves_to=auto, attn=eng.decode_attn,
                    wall_ms_per_step_reps=walls[mode],
                    wall_ms_per_step_median=statistics.median(walls[mode]),
                    device_ms_per_step=line["device_busy_ms"] / DECODE_STEPS,
                    launches_per_step=line["n_kernels"] / DECODE_STEPS,
                    port_launches_per_step={k: n / DECODE_STEPS for k, n in launches.items()})
                print(json.dumps(line), flush=True)
            eng.decode_fused = auto
        del one, eng, fn  # eng and fn hold the last engine of the loop
        torch.cuda.empty_cache()

        # (c) the long-prompt path: chunked admission and a sampled decode chunk
        from tpu_llama_torch.ops.sampling import keys_numpy

        long_prompts = _prompts(rng, cfg, 8, 2048)
        run("prefill_8x2048_chunked", lambda: engine.prefill(long_prompts, list(range(8))),
            layouts="fused", chunk=256)
        temps = np.array([0.0, 0.8] * 4, np.float32)
        topps = np.array([1.0, 0.9, 1.0, 1.0] * 2, np.float32)
        topks = np.array([0, 0, 40, 0] * 2, np.int64)
        keys = keys_numpy(range(8))

        def sampled_chunk():
            engine.decode_sample_chunk(toks, np.full(8, 1024), temps, topps, keys, CHUNK_STEPS,
                                       topks=topks)

        timed(sampled_chunk)
        launches = counted(sampled_chunk)
        wall = timed(sampled_chunk)
        prof, traced_wall = traced(sampled_chunk)
        line = summarize(f"decode_chunk_b8_k{CHUNK_STEPS}_sampled", prof, wall, traced_wall, smi)
        line.update(fused=engine.decode_fused, attn=engine.decode_attn,
                    wall_ms_per_step=wall * 1e3 / CHUNK_STEPS,
                    device_ms_per_step=line["device_busy_ms"] / CHUNK_STEPS,
                    launches_per_step=line["n_kernels"] / CHUNK_STEPS,
                    port_launches_per_step={k: n / CHUNK_STEPS for k, n in launches.items()})
        print(json.dumps(line), flush=True)
        del engine
        torch.cuda.empty_cache()

        # (e) the paged INT8 path: an 8 x 512 compact admission landed by K15,
        # then the b8 decode step at position 512 with fused="auto" (the
        # two-launch K11 + K13 decode) and fused=False (unfused, K13), each
        # warm, timed, then traced
        paged = Engine(params, cfg, max_batch=8, kv_layout="paged", page_size=512, seq_len=2048)

        def paged_prefill():  # each call releases the slots' pages and reserves them anew
            paged.prefill(prompts, list(range(8)), reserve_tokens=[1024] * 8)

        run("prefill_8x512_paged", paged_prefill, layouts="fused", page_size=512,
            pool=type(paged.pool).__name__)
        auto = paged.decode_fused
        for mode in (auto, False):
            paged.decode_fused = mode

            def paged_step():
                paged.decode(toks, np.full(8, 512))

            timed(paged_step)
            launches = counted(paged_step)
            walls = [timed(paged_step) * 1e3 for _ in range(REPS)]
            prof, traced_wall = traced(paged_step)
            line = summarize(f"decode_b8_paged_fused_{mode}", prof, statistics.median(walls) / 1e3,
                             traced_wall, smi)
            line.update(fused=mode, auto_resolves_to=auto, attn=paged.decode_attn,
                        wall_ms_per_step_reps=walls, device_ms_per_step=line["device_busy_ms"],
                        launches_per_step=line["n_kernels"], port_launches_per_step=launches)
            print(json.dumps(line), flush=True)
        paged.decode_fused = auto
        # a paged prefix hit: slot 0's first 300 rows pinned (its boundary page
        # copied), restored into slots 3-7, then one continuation of 5 suffixes
        # of 200 tokens through the mp_cap-bounded page gather
        snap = paged.snapshot_slot(0, 300)
        suffixes = [[int(t) for t in rng.integers(3, cfg.vocab_size, 200)] for _ in range(5)]

        def paged_continue():
            for s in range(3, 8):
                paged.restore_slot(s, snap, reserve_tokens=600)
            paged.prefill_continue(suffixes, list(range(3, 8)), [300] * 5)

        run("continue_5x200_paged", paged_continue, layouts="fused", page_size=512, start=300)
        del paged
        torch.cuda.empty_cache()

        # (f) the pool-direct paged admission (K16 + K17, no compact block): one
        # 8 x 2048 admission (one wave of 8 slots, 8 chunks of 256) and one
        # 32 x 1024 admission (two waves of 16 slots, 4 chunks each), on a
        # 32-slot engine with 97 pages of 512 rows
        direct = Engine(params, cfg, max_batch=32, kv_layout="paged", page_size=512, seq_len=2048,
                        num_pages=97)
        docs = _prompts(rng, cfg, 32, 1024)
        for name, group in (("prefill_8x2048_pool_direct", long_prompts),
                            ("prefill_32x1024_pool_direct", docs)):
            n = len(group)

            def admit(group=group, n=n):  # each call releases the slots' pages and reserves anew
                direct.prefill(group, list(range(n)))

            timed(admit)
            launches = counted(admit)
            wall = timed(admit)
            prof, traced_wall = traced(admit)
            line = summarize(name, prof, wall, traced_wall, smi)
            line.update(layouts="fused", page_size=512, chunk=256, launches=launches,
                        ms_per_launch={k: line["device_ms"].get(k, 0.0) / launches[k]
                                       for k in ("K16", "K17", "K3", "K4", "K5") if launches.get(k)})
            line["ms_per_launch"]["K1+K8"] = line["device_ms"].get("K1+K8", 0.0) / launches["K1"]
            print(json.dumps(line), flush=True)
        del direct, params
        torch.cuda.empty_cache()

    # (d) the server's default model: dense f32 weights, f32 cache; Q8_0, bf16 cache
    dense = fuse_projections(random_params(cfg, dtype=torch.float32, seed=0))
    for weights, kv in (("dense_f32", "float32"), ("q8_0", "bfloat16")):
        if weights == "q8_0":
            dense = quantize_params(dense)  # the f32 weights are freed here
            torch.cuda.empty_cache()
        engine = Engine(dense, cfg, max_batch=8, kv_dtype=kv, seq_len=2048)
        extra = dict(weights=weights, kv_dtype=kv, precision=engine.precision)
        run(f"prefill_8x512_{weights}", prefiller(engine), per_launch=True, **extra)
        engine.prefill(prompts, list(range(8)))

        def step(eng=engine):
            eng.decode(toks, np.full(8, 512))

        run(f"decode_b8_{weights}", step, per_launch=True, attn=engine.decode_attn,
            fused=engine.decode_fused, **extra)
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(dict(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          layers=cfg.n_layers, card=smi)))


def measure(name: str, fn, smi: str, kernels=(), **extra) -> None:
    """One call of ``fn`` warm, counted, timed REPS times, then traced:
    prints its host wall ms (the median and each), device busy ms, every
    port kernel's launches, and the device ms of each of ``kernels`` (ids of
    the trace's groups) in all and per launch."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_llama_torch.ops import _kernels

    fn()
    torch.cuda.synchronize()
    _kernels.reset_counts()
    fn()
    torch.cuda.synchronize()
    launches = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    line = summarize(name, prof, statistics.median(walls) / 1e3, traced_wall, smi)
    dev = line["device_ms"]
    line.update(wall_ms_reps=walls, launches=launches,
                kernel_ms={k: dev.get(k, 0.0) for k in kernels},
                kernel_ms_per_launch={k: dev.get(k, 0.0) / launches[k] for k in kernels
                                      if launches.get(k)}, **extra)
    print(json.dumps(line), flush=True)


def measure_step(name: str, eng, pos: int, smi: str, **extra) -> None:
    """One decode step per call of ``eng`` (all its slots at ``pos``, the
    cache as allocated: a step's time does not depend on the values it
    reads), as ``measure`` takes it, with the device ms of the decode
    attention (K9, K13), the fused layer kernels (K11, K12, K26, K27), the
    row quants (K3, K2) and the flush (K10, K14)."""
    toks = np.random.default_rng(0).integers(3, eng.config.vocab_size, eng.max_batch)
    b = eng.max_batch

    def step():
        eng.decode(toks[:b], np.full(b, pos))

    measure(name, step, smi, ("K9", "K13", "K11", "K12", "K26", "K27", "K3", "K2", "K10", "K14"),
            batch=b,
            pos=pos, attn=eng.decode_attn, fused=eng.decode_fused, **extra)


def mega_steps(cfg, smi: str) -> None:
    """Section (h): the mega2 (K12) and mega3 (K26) decode steps of an
    8-slot engine at position 512 and a one-slot engine at position 2000,
    each measured as ``measure_step`` does.  Uses only the engine's public
    calls, so the same script can time another checkout's package (its
    directory first on PYTHONPATH)."""
    from tpu_llama_torch.models.llama import random_quant_params
    from tpu_llama_torch.runtime import Engine

    params = random_quant_params(cfg, seed=0, fuse=True)
    for b, pos in ((8, 512), (1, 2000)):
        eng = Engine(params, cfg, max_batch=b, kv_dtype="int8", seq_len=2048)
        for mode in ("mega2", "mega3"):
            eng.decode_fused = mode
            measure_step(f"decode_b{b}_pos{pos}_fused_{mode}", eng, pos, smi)
        del eng
        torch.cuda.empty_cache()
    fused_kernels(cfg, params.layers, smi)


def admissions(cfg, smi: str) -> None:
    """Section (i): the W8A8 admissions whose every layer runs two K3 and
    one K2 a pass -- 8 x 512 (the fused prefill body), 8 x 2048 (chunked,
    8 chunks of 256) and the pool-direct 32 x 1024 (two waves of 16 slots)
    -- each as ``measure`` takes it, then the mega2 decode step of
    8 slots at position 512 (``measure_step``: K3 once and K2 twice a
    step).  Uses only the engine's public calls, so the same script can time
    another checkout's package (its directory first on PYTHONPATH)."""
    from tpu_llama_torch.models.llama import random_quant_params
    from tpu_llama_torch.runtime import Engine

    params = random_quant_params(cfg, seed=0, fuse=True)
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, cfg, 8, 512)
    long_prompts = _prompts(rng, cfg, 8, 2048)
    docs = _prompts(rng, cfg, 32, 1024)
    engine = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
    quants = ("K3", "K2")
    measure("prefill_8x512", lambda: engine.prefill(prompts, list(range(8))), smi, quants,
            layouts="fused")
    measure("prefill_8x2048_chunked", lambda: engine.prefill(long_prompts, list(range(8))), smi,
            quants, layouts="fused", chunk=256)
    engine.decode_fused = "mega2"
    measure_step("decode_b8_pos512_fused_mega2", engine, 512, smi)
    del engine
    torch.cuda.empty_cache()
    direct = Engine(params, cfg, max_batch=32, kv_layout="paged", page_size=512, seq_len=2048,
                    num_pages=97)
    measure("prefill_32x1024_pool_direct", lambda: direct.prefill(docs, list(range(32))), smi,
            quants, layouts="fused", page_size=512, chunk=256)
    del direct, params
    torch.cuda.empty_cache()


K12_SHAPES = ((8, [0, 1, 127, 128, 511, 1000, 1900, 2047], 17), (1, [511], 17), (1, [2047], 17),
              (8, [0, 1, 127, 128, 511, 1000, 1900, 2047], 31))


def timed(fn, n):
    """(CUDA-event ms, the trace's device ms) per call of ``fn(i)`` over
    ``n`` back-to-back calls, after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    ev = a.elapsed_time(b) / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    dev = sum(e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return ev, dev


def fused_kernels(cfg, layers, smi: str) -> None:
    """K12 and K26 alone at PERF.md's table shapes (K12 on layer 17, or the
    last layer; K26 on the pair (16, 17), or the last pair), through the
    public wrappers with their default splits, on the engine's weights and a
    random cache: CUDA events over back-to-back calls that rotate through
    the layers (the weights come cold from device memory) and the trace's
    device ms per call."""
    from tpu_llama_torch.ops.fused_step2 import fused_step2_layer
    from tpu_llama_torch.ops.fused_step3 import fused_step3_pair

    L, D, KVH, hd, S = cfg.n_layers, cfg.dim, cfg.n_kv_heads, cfg.head_dim, cfg.seq_len
    gen = torch.Generator(device="cuda").manual_seed(12)
    ws = (layers.wo, layers.w1, layers.w2, layers.wq, layers.rms_ffn, layers.rms_att)

    for B, pos, layer in K12_SHAPES:
        cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
                  for _ in range(2)]
        ang = torch.rand(B, hd // 2, generator=gen, device="cuda") * 6.3
        x = torch.randn(B, D, generator=gen, device="cuda")
        attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda", dtype=torch.int8)
        satt = torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        rest = (*cache, *scales, pt, ang.cos(), ang.sin(), *ws)
        last = layer == L - 1
        k12_layers = [layer] if last else [(layer + i) % (L - 1) for i in range(8)]
        pairs = [L - 2] if last else [2 * ((8 + i) % (L // 2 - 1)) for i in range(8)]
        k12 = timed(lambda i: fused_step2_layer(x, attq, satt, *rest, k12_layers[i % len(k12_layers)],
                                                L, cfg.n_heads), 20)
        k26 = timed(lambda i: fused_step3_pair(x, attq, satt, *rest, pairs[i % len(pairs)], L,
                                               cfg.n_heads), 10)
        print(json.dumps(dict(phase="fused_kernels", batch=B, pos=pos[0] if B == 1 else "mix",
                              layer=layer, k12_events_ms=k12[0], k12_device_ms=k12[1],
                              k26_events_ms=k26[0], k26_device_ms=k26[1], card=smi)), flush=True)
        del cache, scales, rest
        torch.cuda.empty_cache()


def layer_kernels(cfg, layers, smi: str) -> None:
    """K11 alone at batch 8 and 32 on layer 17 and the last layer, and K27
    alone at K12's table shapes (its cells at their default splits), through
    the public wrappers on the engine's weights and a random cache, timed as
    ``fused_kernels`` times K12."""
    from tpu_llama_torch.ops.fused_layer import fused_layer_linear
    from tpu_llama_torch.ops.fused_step import fused_step_layer

    L, D, KVH, hd, S = cfg.n_layers, cfg.dim, cfg.n_kv_heads, cfg.head_dim, cfg.seq_len
    gen = torch.Generator(device="cuda").manual_seed(11)
    ws = (layers.wo, layers.w1, layers.w2, layers.wq, layers.rms_ffn, layers.rms_att)

    def rotation(layer):
        return [layer] if layer == L - 1 else [(layer + i) % (L - 1) for i in range(8)]

    for B in (8, 32):
        for layer in (17, L - 1):
            x = torch.randn(B, D, generator=gen, device="cuda")
            attq = torch.randint(-127, 128, (B, D), generator=gen, device="cuda",
                                 dtype=torch.int8)
            satt = torch.rand(B, generator=gen, device="cuda") * 0.02 + 0.005
            ls = rotation(layer)
            ev, dev = timed(lambda i: fused_layer_linear(x, attq, satt, *ws, ls[i % len(ls)], L),
                            20)
            print(json.dumps(dict(phase="layer_kernels", kernel="K11", batch=B, layer=layer,
                                  events_ms=ev, device_ms=dev, card=smi)), flush=True)
    for B, pos, layer in K12_SHAPES:
        cache = [torch.randint(-127, 128, (L, B, KVH, S, hd), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(L, B, KVH, S, generator=gen, device="cuda") * 0.03 + 0.01
                  for _ in range(2)]
        x = torch.randn(B, D, generator=gen, device="cuda")
        q = torch.randn(B, KVH, 1, hd, generator=gen, device="cuda")
        nk = torch.randint(-127, 128, (B, KVH, hd), generator=gen, device="cuda",
                           dtype=torch.int8)
        nks = torch.rand(B, KVH, generator=gen, device="cuda") * 0.02 + 0.01
        pt = torch.tensor(pos, dtype=torch.int32, device="cuda")
        ls = rotation(layer)
        ev, dev = timed(lambda i: fused_step_layer(x, q, nk, nk, nks, nks, *cache, *scales, pt,
                                                   *ws, ls[i % len(ls)], L), 20)
        print(json.dumps(dict(phase="layer_kernels", kernel="K27", batch=B,
                              pos=pos[0] if B == 1 else "mix", layer=layer, events_ms=ev,
                              device_ms=dev, card=smi)), flush=True)
        del cache, scales
        torch.cuda.empty_cache()


def layer_steps(cfg, smi: str) -> None:
    """Section (j): ``layer_kernels`` and ``fused_kernels``, then the paged
    two-launch decode step
    (K13 + K11 per layer, ``fused="auto"`` on a paged cache), the mega step
    (K27 per layer) and the mega2 step (K12 per layer) of 8 slots at
    position 512, each as ``measure_step`` takes it.  Uses only public
    signatures, so the same script can time another checkout's package (its
    directory first on PYTHONPATH)."""
    from tpu_llama_torch.models.llama import random_quant_params
    from tpu_llama_torch.runtime import Engine

    params = random_quant_params(cfg, seed=0, fuse=True)
    layer_kernels(cfg, params.layers, smi)
    fused_kernels(cfg, params.layers, smi)
    paged = Engine(params, cfg, max_batch=8, kv_layout="paged", page_size=512, seq_len=2048)
    paged.prefill([[1] * 16] * 8, list(range(8)), reserve_tokens=[2048] * 8)
    measure_step("decode_b8_pos512_paged", paged, 512, smi, page_size=512)
    del paged
    torch.cuda.empty_cache()
    eng = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
    for mode in ("mega", "mega2"):
        eng.decode_fused = mode
        measure_step(f"decode_b8_pos512_fused_{mode}", eng, 512, smi)
    del eng, params
    torch.cuda.empty_cache()


TP_SPAN_SHAPES = ((1, 8), (2, 8), (4, 8), (8, 8), (1, 32))  # (tp, batch)


def span_kernels(cfg, smi: str) -> None:
    """K23 and K24 alone at TP_SPAN_SHAPES: 7B's local widths (D, Hl =
    H / tp, QOl = (D + 2 KVD) / tp) on four layers of random local weights,
    calls rotating through them (the weights come cold from device memory),
    timed as ``fused_kernels`` times K12."""
    from tpu_llama_torch.ops.fused_layer import fused_ffn_stacked, fused_rms_qkv_stacked
    from tpu_llama_torch.ops.quant import ChannelQuantTensor

    Lw, D = 4, cfg.dim
    gen = torch.Generator(device="cuda").manual_seed(23)

    def qt(n_in, n_out):
        return ChannelQuantTensor(
            q=torch.randint(-127, 128, (Lw, n_out, n_in), generator=gen, device="cuda",
                            dtype=torch.int8),
            s=torch.rand(Lw, n_out, generator=gen, device="cuda") * 2e-4 + 1e-4)

    for tp, B in TP_SPAN_SHAPES:
        Hl, QOl = cfg.hidden_dim // tp, (D + 2 * cfg.n_kv_heads * cfg.head_dim) // tp
        w13, w2, wqkv = qt(D, 2 * Hl), qt(Hl, D), qt(D, QOl)
        rms = (1 + 0.1 * torch.randn(Lw, D, generator=gen, device="cuda")).to(torch.bfloat16)
        x = torch.randn(B, D, generator=gen, device="cuda")
        k23 = timed(lambda i: fused_ffn_stacked(x, w13, w2, rms, i % Lw), 20)
        k24 = timed(lambda i: fused_rms_qkv_stacked(x, wqkv, rms, i % Lw), 20)
        print(json.dumps(dict(phase="span_kernels", tp=tp, batch=B, Hl=Hl, QOl=QOl,
                              k23_events_ms=k23[0], k23_device_ms=k23[1],
                              k24_events_ms=k24[0], k24_device_ms=k24[1], card=smi)), flush=True)
        del w13, w2, wqkv
        torch.cuda.empty_cache()


def tp_spans(cfg, smi: str) -> None:
    """Section (k): ``span_kernels``, then the fused TP decode step at tp =
    1 on a single-device mesh (the kernels phase 4i's tp = 1 rank runs: K8,
    K9, K2, K23, K24, K10, the classifier's K1; collectives the identity):
    8 slots admitted at 512 tokens, one step per call at position 512,
    as ``measure`` takes it."""
    from tpu_llama_torch.models.llama import random_quant_params, tp_interleave
    from tpu_llama_torch.parallel.mesh import single_device_mesh
    from tpu_llama_torch.parallel.sharding import shard_params
    from tpu_llama_torch.runtime import Engine

    span_kernels(cfg, smi)
    mesh = single_device_mesh("cuda")
    params = shard_params(tp_interleave(random_quant_params(cfg, seed=0, fuse=True), cfg, 1),
                          mesh)
    eng = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048, mesh=mesh,
                 tp_fused=True)
    rng = np.random.default_rng(0)
    eng.prefill(_prompts(rng, cfg, 8, 512), list(range(8)))
    toks = torch.tensor(rng.integers(3, cfg.vocab_size, 8), device="cuda")
    pos = torch.full((8,), 512, device="cuda")
    measure("decode_b8_pos512_tp1_fused", lambda: eng.decode_device(toks, pos), smi,
            ("K23", "K24", "K1+K8", "K9", "K2", "K10"), batch=8, pos=512, tp=1)
    del eng, params
    torch.cuda.empty_cache()


HBM_BYTES_S = 3.35e12  # the H100 SXM's device memory rate (PERF.md's bounds)
FLUSH_POS = [0, 1, 127, 128, 511, 1000, 2048, 2047]  # chip_smoke.py's K10 set: slot 6 at pos S
FLUSH_POS32 = ([0, 1, 127, 128, 511, 1000, 1900, 2047]
               + [int(p) for p in np.random.default_rng(32).integers(0, 2048, 24)])


def flush_cases(cfg, kernels=("K10", "K14", "K28")):
    """The flush kernels at chip_smoke.py's shapes, one case at a time: a
    dict of its label, kernel id, ``call(i)`` of the wrapper, ``plain(i)``
    (its plain version), ``lib(i)`` (one indexed write per array) and the
    bytes its bound counts (every input read once, every output written
    once).  K10 INT8, f32 and bf16 on a [32, 8, 32, 2048, 128] cache at
    FLUSH_POS; K14 at batch 8 on a 33-page pool and batch 32 on a 129-page
    one, pages of 512 rows in no order, slot 6 past its table and slot 1
    parked; K28 INT8 on a [8, 8, 32, 2048, 128] cache, the layer turning.
    Calls rotate over 8 copies of the rows, which stay in the L2 as a
    step's do (its own kernels just wrote them).
    ``kernels``: the ids whose cases are made (K10 for all three forms)."""
    from tpu_llama_torch.ops import attention as tatt

    gen = torch.Generator(device="cuda").manual_seed(10)
    L, KVH, S, hd, B, copies = cfg.n_layers, cfg.n_kv_heads, cfg.seq_len, cfg.head_dim, 8, 8

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def rf(*shape):
        return torch.rand(*shape, generator=gen, device="cuda")

    def cached(kernel, fn, args, copies_of, **case):
        def call(i, fn=fn):
            fn(*args(copies_of[i % copies]))
        return dict(kernel=kernel, call=call, **case)

    pt = torch.tensor(FLUSH_POS, dtype=torch.int32, device="cuda")
    ok = torch.tensor([b for b, p in enumerate(FLUSH_POS) if 0 <= p < S], device="cuda")
    ix = (torch.arange(L, device="cuda")[:, None, None], ok[None, :, None],
          torch.arange(KVH, device="cuda")[None, None, :], pt[ok].long()[None, :, None])
    for dt in (torch.int8, torch.float32, torch.bfloat16) if "K10" in kernels else ():
        int8 = dt == torch.int8
        if int8:
            cache = [ri(L, B, KVH, S, hd), ri(L, B, KVH, S, hd), rf(L, B, KVH, S),
                     rf(L, B, KVH, S)]
            rows = [(ri(L, B, KVH, hd), ri(L, B, KVH, hd), rf(L, B, KVH), rf(L, B, KVH))
                    for _ in range(copies)]
        else:
            cache = [torch.randn(L, B, KVH, S, hd, generator=gen, device="cuda").to(dt)
                     for _ in range(2)]
            rows = [tuple(torch.randn(L, B, KVH, hd, generator=gen, device="cuda").to(dt)
                          for _ in range(2)) for _ in range(copies)]

        def args10(r, cache=cache):
            return (r[0], r[1], pt, cache[0], cache[1], *r[2:], *cache[2:])

        def lib10(i, rows=rows, cache=cache):
            for c, r in zip(cache, rows[i % copies]):
                c[ix] = r[:, ok]

        kernel = "K10" if int8 else f"K10:{'f32' if dt == torch.float32 else 'bf16'}"
        case = cached(kernel, tatt.kv_cache_flush_rows, args10, rows, lib=lib10,
                      label=f"{kernel} L={L} B={B} KVH={KVH} S={S} hd={hd}",
                      nbytes=2 * L * len(ok) * KVH * (2 * hd * cache[0].element_size()
                                                       + 8 * int8) + 4 * B)
        case["plain"] = lambda i, c=case["call"]: c(i, tatt.kv_cache_flush_rows_plain)
        yield case
        del cache, rows, case
        torch.cuda.empty_cache()
    ps, MP = 512, S // 512
    for B, seed in ((8, 0), (32, 5)) if "K14" in kernels else ():
        P = B * MP + 1
        pool = [ri(L, P, KVH, ps, hd), ri(L, P, KVH, ps, hd), rf(L, P, KVH, ps),
                rf(L, P, KVH, ps)]
        rng = np.random.default_rng(seed)
        table = torch.tensor(rng.permutation(np.arange(1, P)).reshape(B, MP).astype(np.int32),
                             device="cuda")
        table[1] = 0  # a parked slot
        pos = list(FLUSH_POS32[:B])
        pos[6] = MP * ps  # past the slot's table: the trash page
        p32 = torch.tensor(pos, dtype=torch.int32, device="cuda")
        rows = [(ri(L, B, KVH, hd), ri(L, B, KVH, hd), rf(L, B, KVH), rf(L, B, KVH))
                for _ in range(copies)]
        okp, page, row = tatt._flush_targets(p32, table, P, ps)
        ixp = (torch.arange(L, device="cuda")[:, None, None], page[None, :, None],
               torch.arange(KVH, device="cuda")[None, None, :], row[None, :, None])

        def args14(r, p32=p32, table=table, pool=pool):
            return (*r, p32, table, *pool)

        def lib14(i, rows=rows, pool=pool, okp=okp, ixp=ixp):
            for a, r in zip(pool, rows[i % copies]):
                a[ixp] = r[:, okp]

        case = cached("K14", tatt.kv_pool_flush_rows, args14, rows, lib=lib14,
                      label=f"K14 L={L} B={B} KVH={KVH} ps={ps} P={P}",
                      nbytes=2 * L * B * KVH * (2 * hd + 8) + 4 * B * (MP + 1))
        case["plain"] = lambda i, c=case["call"]: c(i, tatt.kv_pool_flush_rows_plain)
        yield case
        del pool, rows, case
        torch.cuda.empty_cache()
    if "K28" not in kernels:
        return
    L8, B, layer = 8, 8, 5
    cache = [ri(L8, B, KVH, S, hd), ri(L8, B, KVH, S, hd), rf(L8, B, KVH, S), rf(L8, B, KVH, S)]
    rows = [(torch.randn(B, KVH, hd, generator=gen, device="cuda") * 3,
             torch.randn(B, KVH, hd, generator=gen, device="cuda") * 3) for _ in range(copies)]
    quant = [(kq, vq, ks, vs) for (kq, ks), (vq, vs) in
             ((tatt.quantize_kv(k), tatt.quantize_kv(v)) for k, v in rows)]
    ix28 = (ok[:, None], torch.arange(KVH, device="cuda")[None, :], pt[ok].long()[:, None])

    def call28(i, fn=tatt.kv_cache_write_decode):
        fn(*rows[i % copies], pt, (layer + i) % L8, *cache)

    def lib28(i):
        for c, r in zip(cache, quant[i % copies]):
            c[(layer + i) % L8][ix28] = r[ok]

    yield dict(kernel="K28", call=call28,
               plain=lambda i: call28(i, tatt.kv_cache_write_decode_plain), lib=lib28,
               label=f"K28 int8 L={L8} B={B} KVH={KVH} S={S} hd={hd}",
               nbytes=2 * B * KVH * hd * 4 + 4 * B + 2 * len(ok) * KVH * (hd + 4))
    del cache, rows, quant
    torch.cuda.empty_cache()


def flush_steps(cfg, smi: str) -> None:
    """Section (l): every ``flush_cases`` case alone -- CUDA events over
    back-to-back calls and the trace's device ms (``timed``) of the
    wrapper, its plain version and the library call, beside the bytes
    bound -- then the paged two-launch decode step (K14, and K13 + K11 per
    layer) and the mega2 step (K10) of 8 slots at position 512, each as
    ``measure_step`` takes it.  Uses only public signatures, so the same
    script can time another checkout's package (its directory first on
    PYTHONPATH)."""
    from tpu_llama_torch.models.llama import random_quant_params
    from tpu_llama_torch.runtime import Engine

    for case in flush_cases(cfg):
        ev, dev = timed(case["call"], 50)
        plain = timed(case["plain"], 10)
        lib = timed(case["lib"], 20)
        print(json.dumps(dict(phase="flush_kernels", kernel=case["kernel"], shape=case["label"],
                              events_ms=ev, device_ms=dev, plain_ms=plain[0],
                              plain_device_ms=plain[1], library_ms=lib[0],
                              library_device_ms=lib[1],
                              bound_ms=case["nbytes"] / HBM_BYTES_S * 1e3, card=smi)),
              flush=True)
        del case
    params = random_quant_params(cfg, seed=0, fuse=True)
    paged = Engine(params, cfg, max_batch=8, kv_layout="paged", page_size=512, seq_len=2048)
    paged.prefill([[1] * 16] * 8, list(range(8)), reserve_tokens=[2048] * 8)
    measure_step("decode_b8_pos512_paged", paged, 512, smi, page_size=512)
    del paged
    torch.cuda.empty_cache()
    eng = Engine(params, cfg, max_batch=8, kv_dtype="int8", seq_len=2048)
    eng.decode_fused = "mega2"
    measure_step("decode_b8_pos512_fused_mega2", eng, 512, smi)
    del eng, params
    torch.cuda.empty_cache()


def decode_steps(cfg, smi: str) -> None:
    """Section (g): one decode step per call of each engine below, timed
    REPS times after a warm call, then traced (``measure_step``)."""
    from tpu_llama_torch.models.llama import (
        fuse_projections,
        quantize_params,
        random_params,
        random_quant_params,
    )
    from tpu_llama_torch.runtime import Engine

    def measure(name, eng, pos, **extra):
        measure_step(name, eng, pos, smi, **extra)

    params = random_quant_params(cfg, seed=0, fuse=True)
    one = Engine(params, cfg, max_batch=1, kv_dtype="int8", seq_len=2048)
    auto = one.decode_fused
    for mode in (True, auto):  # the two-launch decode, then mega2
        one.decode_fused = mode
        measure(f"decode_b1_pos2000_fused_{mode}", one, 2000)
    del one
    paged = Engine(params, cfg, max_batch=8, kv_layout="paged", page_size=512, seq_len=2048)
    paged.prefill([[1] * 16] * 8, list(range(8)), reserve_tokens=[2048] * 8)
    measure("decode_b8_pos512_paged", paged, 512, page_size=512)
    del paged
    paged1 = Engine(params, cfg, max_batch=1, kv_layout="paged", page_size=512, seq_len=2048)
    paged1.prefill([[1] * 16], [0], reserve_tokens=[2048])
    measure("decode_b1_pos2000_paged", paged1, 2000, page_size=512)
    del paged1, params
    torch.cuda.empty_cache()
    dense = fuse_projections(random_params(cfg, dtype=torch.float32, seed=0))
    for weights, kv in (("dense_f32", "float32"), ("q8_0", "bfloat16")):
        if weights == "q8_0":
            dense = quantize_params(dense)  # the f32 weights are freed here
            torch.cuda.empty_cache()
        engine = Engine(dense, cfg, max_batch=8, kv_dtype=kv, seq_len=2048)
        measure(f"decode_b8_pos512_{weights}", engine, 512, weights=weights, kv_dtype=kv)
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Start the ranks of a tensor-parallel run, and the rank entry points.

``run(fn, mesh_config, args, backend=..., device=...)`` starts one process
per rank with ``torch.multiprocessing``'s spawn method, joins them to a
process group at ``tcp://127.0.0.1:<a free port>`` over the caller's backend
(``"gloo"`` on the CPU or for ranks that share one card, ``"nccl"`` for one
rank per card), builds each rank's ``Mesh`` on ``device`` (default the card:
``make_mesh`` raises where there is none) and calls ``fn(mesh, *args)``
there.  It returns the ranks' results in rank
order, and raises -- after ending every rank -- when one fails or the run
outlasts its ``timeout``.  The children import torch and this package only:
``fn`` is a function of this module (or of another module of the package).

The entry points below drive the port's TP paths from a seed: the tests
(on the CPU, against the JAX package's results computed in the test
process) and ``chip_smoke.py`` (on the card) call them.  Every rank builds
the same full weights from the seed, keeps its shard, and runs the same
program on the same inputs (SPMD).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.io.checkpoint import make_random_weights
from tpu_llama_torch.models.llama import (
    fuse_projections,
    make_kv_cache,
    params_from_raw,
    quantize_params,
    random_quant_params,
    tp_interleave,
)
from tpu_llama_torch.ops.quant import ChannelQuantTensor, dequantize_channel
from tpu_llama_torch.parallel.mesh import (
    DATA_AXIS,
    HOST_STAGED,
    MODEL_AXIS,
    MeshConfig,
    init_distributed,
    make_mesh,
)
from tpu_llama_torch.parallel.sharding import shard_params
from tpu_llama_torch.parallel.tp import (
    _local_config,
    tp_forward_decode,
    tp_forward_decode_fused,
    tp_forward_prefill,
)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(rank: int, world: int, address: str, backend: str, mesh_config: MeshConfig,
           device, threads: int, fn, args, out_dir: str) -> None:
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        torch.set_num_threads(threads)
        init_distributed(address, world, rank, backend)
        mesh = make_mesh(mesh_config, device)
        result = fn(mesh, *args)
        dist.barrier()
        dist.destroy_process_group()
        with open(path + ".pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run(fn, mesh_config: MeshConfig, args=(), *, backend: str, device=None,
        timeout: float = 120.0, threads: int = 1) -> list:
    """``fn(mesh, *args)`` on every rank of a ``mesh_config`` mesh, one
    spawned process each; returns their results in rank order.  Raises
    RuntimeError with the failing rank's traceback, or TimeoutError after
    ``timeout`` seconds; either way no rank outlives the call."""
    world = mesh_config.n_devices
    ctx = mp.get_context("spawn")
    address = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_child, args=(r, world, address, backend, mesh_config,
                                                  device, threads, fn, args, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break  # a rank failed: the others may wait on it forever
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__}: the ranks ran past {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errs = [os.path.join(out_dir, f"rank{r}.err") for r in range(world)]
        failed = [(r, open(e).read()) for r, e in enumerate(errs) if os.path.exists(e)]
        if failed or any(p.exitcode != 0 for p in procs):
            detail = "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in failed)
            raise RuntimeError(f"{fn.__name__} failed: exit codes "
                               f"{[p.exitcode for p in procs]}\n{detail}")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


# ---------------------------------------------------------------------------
# rank entry points
# ---------------------------------------------------------------------------


def batch(mesh, calls) -> dict:
    """Several entry points in one run: ``calls`` = [(key, fn, kwargs)] ->
    {key: fn(mesh, **kwargs)}."""
    return {key: fn(mesh, **kw) for key, fn, kw in calls}


def tp_params(mesh, config: ModelConfig, seed: int, fuse: bool = False, quant: str | None = None,
              group_size: int | None = None):
    """This rank's shard of ``make_random_weights(config, seed)`` (the JAX
    package's numpy stream), optionally ``fuse_projections(tp=...)`` and
    then quantized (``quantize_params(mode=quant)``)."""
    params = params_from_raw(make_random_weights(config, seed=seed), device="cpu")
    if fuse:
        params = fuse_projections(params, tp=mesh.size(MODEL_AXIS))
    if quant is not None:
        params = quantize_params(params, group_size=group_size, mode=quant)
    return shard_params(params, mesh)


def decode_roll(mesh, config: ModelConfig, seed: int, tokens, steps: int, kv=None,
                fused_kernels: bool = False, feed: str = "step", prompt=None, fuse: bool = False,
                quant: str | None = None, group_size: int | None = None, **kw) -> dict:
    """``steps`` TP decode steps on a fresh local cache (``kv`` its dtype,
    default float32): step p feeds ``tokens + p`` (``feed="step"``) or the
    last step's greedy picks (``"argmax"``, starting from ``tokens``) at
    position p.  With ``prompt`` ([B, T] tokens) ``tp_forward_prefill``
    fills the cache first and the decode starts from its greedy picks at
    position T + p.  ``fused_kernels`` takes ``tp_forward_decode_fused``;
    ``kw`` goes to the decode step.  Returns every step's logits [B, V], the
    greedy picks (the prefill's first) and this rank's cache K, as numpy."""
    params = tp_params(mesh, config, seed, fuse, quant, group_size)
    dev = mesh.device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
    B = tokens.shape[0]
    cache = _local_cache(config, mesh, B, kv)
    step = tp_forward_decode_fused if fused_kernels else tp_forward_decode
    out = {"logits": [], "tokens": []}
    t, start = tokens, torch.zeros(B, dtype=torch.long, device=dev)
    if prompt is not None:
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
        start = torch.full((B,), toks.shape[1], dtype=torch.long, device=dev)
        logits, cache = tp_forward_prefill(params, cache, toks, torch.zeros_like(start), start,
                                           config, mesh)
        t = logits.argmax(-1)
        out["tokens"].append(t.cpu().numpy())
    for p in range(steps):
        logits, cache = step(params, cache, tokens + p if feed == "step" else t, start + p,
                             config, mesh, **kw)
        t = logits.argmax(-1)
        out["logits"].append(logits.cpu().numpy())
        out["tokens"].append(t.cpu().numpy())
    out["cache_k"] = cache.k.cpu().numpy()
    return out


def _local_cache(config: ModelConfig, mesh, B: int, kv):
    """A fresh local cache for a global batch of B on ``mesh``."""
    return make_kv_cache(_local_config(config, mesh.size(MODEL_AXIS)), B // mesh.size(DATA_AXIS),
                         kv_dtype=kv or "float32", device=mesh.device)


def prefill_case(mesh, config: ModelConfig, seed: int, tokens, lengths, fuse: bool = False,
                 **kw) -> dict:
    """``tp_forward_prefill`` of ``tokens`` [B, T] at start 0 on a fresh
    f32 cache: the last-token logits and this rank's local cache K."""
    params = tp_params(mesh, config, seed, fuse)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=mesh.device)
    cache = _local_cache(config, mesh, toks.shape[0], None)
    n = torch.as_tensor(np.asarray(lengths), dtype=torch.long, device=mesh.device)
    logits, cache = tp_forward_prefill(params, cache, toks, torch.zeros_like(n), n, config,
                                       mesh, **kw)
    return {"logits": logits.cpu().numpy(), "cache_k": cache.k.cpu().numpy()}


def refused(mesh, config: ModelConfig, seed: int, quant: str) -> str:
    """The ValueError ``tp_forward_decode`` raises on padded quantized
    shards ('' if it ran)."""
    params = tp_params(mesh, config, seed, quant=quant)
    cache = _local_cache(config, mesh, 2, None)
    try:
        tp_forward_decode(params, cache, torch.tensor([5, 9], device=mesh.device),
                          torch.zeros(2, dtype=torch.long, device=mesh.device), config, mesh)
    except ValueError as e:
        return str(e)
    return ""


def serve(mesh, config: ModelConfig, seed: int, prompts, steps: int, max_batch: int) -> dict:
    """``Engine(mesh=mesh, tp_fused=True)`` on ``fuse_projections(tp)`` W8A8
    shards of ``make_random_weights(config, seed)`` over an INT8 cache, with a
    ``ContinuousBatcher`` serving greedy requests for ``prompts`` (token
    lists without BOS) of ``steps`` positions each, on every rank.  Rank 0
    alone emits (its requests carry the ``on_token`` callback).  Returns the
    streams in submission order, and what rank 0 emitted."""
    from tpu_llama_torch.runtime.engine import Engine
    from tpu_llama_torch.runtime.scheduler import ContinuousBatcher, Request

    params = tp_params(mesh, config, seed, fuse=True, quant="w8a8")
    engine = Engine(params, config, max_batch=max_batch, kv_dtype="int8", mesh=mesh,
                    tp_fused=True)
    emitted = []
    batcher = ContinuousBatcher(engine)
    reqs = []
    for i, p in enumerate(prompts):
        cb = (lambda tok, i=i: emitted.append((i, tok))) if mesh.rank == 0 else None
        reqs.append(Request(prompt_tokens=list(p), steps=steps, temperature=0.0,
                            on_token=cb))
        batcher.submit(reqs[-1])
    batcher.run()
    return {"streams": [r.out_tokens for r in reqs], "emitted": emitted}


# ---------------------------------------------------------------------------
# the TP serving path on the card at full width (chip_smoke.py)
# ---------------------------------------------------------------------------


def probe(engine, prompts, steps: int, teacher=None) -> dict:
    """Logits of an engine's path: ``prompts`` admitted into slots 0..n-1
    in one ``prefill``, then ``steps`` decode steps of all slots, the first
    n fed their greedy picks (or the rows of ``teacher`` [steps, n], so
    that two engines see the same inputs), the others token 0 at position
    0.  Returns the prefill's and every step's logits [n, V] and the picks,
    as numpy."""
    n, B = len(prompts), engine.max_batch
    logits = engine.prefill(prompts, list(range(n)))
    out = {"prefill": logits, "decode": [], "picks": [logits.argmax(-1)]}
    pos = np.zeros(B, np.int64)
    pos[:n] = [len(p) for p in prompts]
    toks = np.zeros(B, np.int64)
    for i in range(steps):
        toks[:n] = out["picks"][-1] if teacher is None else teacher[i]
        step = engine.decode(toks, pos)[:n]
        out["decode"].append(step)
        out["picks"].append(step.argmax(-1))
        pos[:n] += 1
    return out


def _cpu_busy_ms(prof, words) -> float:
    """Host milliseconds inside profiler CPU events whose names hold any of
    ``words`` (the union of their intervals: nested events count once)."""
    from torch.autograd import DeviceType

    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CPU and any(w in e.name.lower() for w in words))
    total, end = 0.0, -1.0
    for s, e in iv:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def _prompt_batch(prompts, dev):
    """Token lists -> (tokens [n, T] padded with 0, lengths [n]) on ``dev``."""
    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return torch.tensor(toks, device=dev), torch.tensor([len(p) for p in prompts], device=dev)


def _dequantized(params):
    """``params`` with every per-channel W8A8 leaf dequantized to dense f32
    [..., in, out] (q * s): the same model without an activation quant."""
    lp = params.layers

    def dense(w):
        return dequantize_channel(w).contiguous() if isinstance(w, ChannelQuantTensor) else w

    return dataclasses.replace(params, wcls=dense(params.wcls), layers=dataclasses.replace(
        lp, **{f.name: dense(getattr(lp, f.name)) for f in dataclasses.fields(lp)}))


def logits_err(got, want) -> float:
    """max |got - want| over max |want| (inf where got is not finite or not
    want's shape)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max() / np.abs(want).max())


def run_gap(got, want, forced=False) -> dict:
    """Two rolls of ``tp_parity`` on the same prompts: the step whose greedy
    picks first part (None: never) and each step's logits error
    (``logits_err``) while both saw the same inputs: every step where
    ``got`` was fed ``want``'s picks (``forced``), else up to that step."""
    part = next((i for i, (a, b) in enumerate(zip(got["picks"], want["picks"]))
                 if not np.array_equal(a, b)), None)
    last = len(want["logits"]) if forced or part is None else part + 1
    return dict(parted_at=part, logits_err=[logits_err(g, w) for g, w in
                                            zip(got["logits"][:last], want["logits"][:last])])


def parity_reading(card, cpu) -> dict:
    """Card against CPU (``tp_parity`` on each), for each TP decode: the
    step the greedy picks first part (None: never), the logits' largest
    error over max |logit| up to that step (the same inputs on both sides),
    and at the parting step the CPU's gap between the two logits that
    swapped places and the largest |card - CPU| logit error of those
    rows."""
    out = {}
    for mode in ("fused", "unfused"):
        g, c = card[mode], cpu[mode]
        gap = run_gap(g, c)
        part = gap["parted_at"]
        rd = dict(parted_at=part, steps=len(c["picks"]), logits_err=max(gap["logits_err"]))
        if part is not None:
            rows = np.nonzero(g["picks"][part] != c["picks"][part])[0]
            cl, gl = c["logits"][part][rows], g["logits"][part][rows]
            rd["gap"] = float(np.max(cl[np.arange(len(rows)), c["picks"][part][rows]]
                                     - cl[np.arange(len(rows)), g["picks"][part][rows]]))
            rd["row_err"] = float(np.abs(gl - cl).max())
        out[mode] = rd
    return out


def tp_parity(mesh, config: ModelConfig, seed: int, prompts, steps: int) -> dict:
    """The TP paths on a small model, the same function on the card and on
    the CPU: ``random_quant_params(config, seed, fuse=True, norm_dtype=
    float32)`` drawn on the CPU (so every machine and rank draws alike; f32
    activations), ``tp_interleave``'d and sharded onto the mesh's device.
    Each roll is ``tp_prefill_into_slots`` of ``prompts`` (K6, K7), then
    ``steps`` decode steps fed their greedy picks or a teacher's:

    * ``"fused"``: the fused TP decode (``attn="flash_dma"``: K9 on both
      sides) on an INT8 cache;
    * ``"unfused"``: the unfused one (``"flash"``: K21) on an INT8 cache;
    * ``"single"`` (tp = 1 only): the single-device unfused decode
      (``forward_decode``, ``attn="flash"``: deferred flush, K19 + K10) from
      the same admission, fed ``"unfused"``'s picks;
    * ``"overlap"``: the unfused TP decode on the weights dequantized to
      dense f32 (``precision="highest"``) over an f32 cache, as
      {"allreduce": the all-reduce form, "ring": ``overlap=True``, the ring
      collective matmul for wo and w2, fed the all-reduce form's picks}.

    Each roll's logits and picks; the launches, plain calls and host-staged
    ring hops of the whole run."""
    from tpu_llama_torch.models.llama import forward_decode
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.parallel.tp import tp_prefill_into_slots

    tp, dev = mesh.size(MODEL_AXIS), mesh.device
    full = random_quant_params(config, seed=seed, fuse=True, norm_dtype=torch.float32,
                               device="cpu")
    params = shard_params(tp_interleave(full, config, tp), mesh)
    toks, lengths = _prompt_batch(prompts, dev)
    n = len(prompts)
    _kernels.reset_counts()
    HOST_STAGED["ring_shift"] = 0

    def roll(step, p, kv, teacher=None):
        cache = make_kv_cache(_local_config(config, tp), n, kv_dtype=kv,
                              seq_len=toks.shape[1] + steps, device=dev)
        logits, cache = tp_prefill_into_slots(p, cache, toks, lengths, list(range(n)), config,
                                              mesh, attn="flash")
        got = {"logits": [logits.cpu().numpy()], "picks": [logits.argmax(-1).cpu().numpy()]}
        pos = lengths.clone()
        for i in range(steps):
            t = logits.argmax(-1) if teacher is None else torch.as_tensor(teacher[i], device=dev)
            logits, cache = step(p, cache, t, pos)
            got["logits"].append(logits.cpu().numpy())
            got["picks"].append(logits.argmax(-1).cpu().numpy())
            pos = pos + 1
        return got

    def tp_step(fn, **kw):
        return lambda p, cache, t, pos: fn(p, cache, t, pos, config, mesh, **kw)

    out = {"fused": roll(tp_step(tp_forward_decode_fused, attn="flash_dma"), params, "int8"),
           "unfused": roll(tp_step(tp_forward_decode, attn="flash"), params, "int8")}
    if tp == 1:
        out["single"] = roll(
            lambda p, cache, t, pos: forward_decode(p, cache, t, pos, config, attn="flash",
                                                    fused=False, precision="default"),
            params, "int8", teacher=out["unfused"]["picks"])
    dense = _dequantized(params)
    ar = roll(tp_step(tp_forward_decode, attn="flash", precision="highest"), dense, "float32")
    out["overlap"] = {"allreduce": ar, "ring": roll(
        tp_step(tp_forward_decode, attn="flash", precision="highest", overlap=True), dense,
        "float32", teacher=ar["picks"])}
    _sync(dev)
    out["launches"] = {k: c for k, c in _kernels.LAUNCHES.items() if c}
    out["plain"] = {k: c for k, c in _kernels.PLAIN_CALLS.items() if c}
    out["host_staged"] = HOST_STAGED["ring_shift"]
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def serve_card(mesh, config: ModelConfig, seed: int, prompts, probe_steps: int, teacher,
               requests, unfused_steps: int, fp_steps: int, timed_steps: int,
               max_batch: int = 8, seq_len: int = 2048, parity=None) -> dict:
    """The TP serving path on the card: ``random_quant_params(config, seed,
    fuse=True)`` made on the card (the weights every rank and the
    single-device engine draw alike), put in ``tp_interleave``'s order and
    sharded; ``Engine(mesh=mesh, tp_fused=True)`` with a dense INT8 cache.
    In turn: ``probe`` (the prefill and ``probe_steps`` fused TP decode
    steps fed ``teacher``); a ``ContinuousBatcher`` serving greedy
    ``requests`` ((prompt, steps) pairs, top-2 logprobs recorded; rank 0
    alone emits), the kernel launches of that run counted; the unfused
    ``tp_forward_decode`` (K21) for ``unfused_steps`` steps after a TP
    admission of ``prompts`` into an INT8 cache of the engine's shape, fed
    ``teacher``, then ``fp_steps`` steps each on f32 and bf16 caches, their
    launches counted; then all slots admitted at 512 tokens and
    ``timed_steps`` fused decode steps timed (host wall per step), one step
    counted and four traced (device busy ms, host ms inside the
    collectives).  ``parity``
    ((config, seed, prompts, steps)) first runs ``tp_parity`` on the same
    mesh."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.parallel.tp import tp_prefill_into_slots
    from tpu_llama_torch.profile_serving import _busy_us, _kernel_events
    from tpu_llama_torch.runtime.engine import Engine
    from tpu_llama_torch.runtime.scheduler import ContinuousBatcher, Request

    tp, dev = mesh.size(MODEL_AXIS), mesh.device
    small = None if parity is None else tp_parity(mesh, *parity)
    full = random_quant_params(config, seed=seed, fuse=True, device=mesh.device)
    params = shard_params(tp_interleave(full, config, tp), mesh)
    del full
    _free(dev)
    engine = Engine(params, config, max_batch=max_batch, kv_dtype="int8", seq_len=seq_len,
                    mesh=mesh, tp_fused=True)
    out = {"rank": mesh.rank, "parity": small,
           "probe": probe(engine, prompts, probe_steps, teacher)}

    engine.cache.zero_()
    emitted = []
    reqs = [Request(prompt_tokens=list(p), steps=s, temperature=0.0, logprobs=2,
                    on_token=(lambda t: emitted.append(t)) if mesh.rank == 0 else None)
            for p, s in requests]
    batcher = ContinuousBatcher(engine)
    for r in reqs:
        batcher.submit(r)
    _kernels.reset_counts()
    t0 = time.perf_counter()
    batcher.run()
    _sync(dev)
    out["serve_s"] = time.perf_counter() - t0
    out["serve_launches"] = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    out["serve_plain"] = {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}
    out["streams"] = [r.out_tokens for r in reqs]
    out["top"] = [r.out_top_logprobs for r in reqs]
    out["emitted"] = len(emitted)

    # the unfused TP decode, write-then-attend through K21, on the engine's
    # cache shape (max_batch slots of seq_len rows): the INT8 cache fed
    # ``teacher``, then f32 and bf16 caches (K21's fp forms) for ``fp_steps``
    # steps; the slots past the prompts take token 0 at position 0, as
    # ``probe``'s do
    n = len(prompts)
    toks, lengths = _prompt_batch(prompts, dev)
    local = _local_config(config, tp)
    _kernels.reset_counts()
    for kv, steps in (("int8", unfused_steps), ("float32", fp_steps), ("bfloat16", fp_steps)):
        cache = make_kv_cache(local, max_batch, kv_dtype=kv, seq_len=seq_len, device=dev)
        _, cache = tp_prefill_into_slots(params, cache, toks, lengths, list(range(n)), config,
                                         mesh)
        t = torch.zeros(max_batch, dtype=torch.long, device=dev)
        pos = torch.zeros(max_batch, dtype=torch.long, device=dev)
        pos[:n] = lengths
        got = []
        for i in range(steps):
            t[:n] = torch.as_tensor(teacher[i], device=dev)
            logits, cache = tp_forward_decode(params, cache, t, pos, config, mesh)
            got.append(logits[:n].cpu().numpy())
            pos[:n] += 1
        out[f"unfused_{kv}"] = got
        del cache
    _sync(dev)
    out["unfused_launches"] = {k: c for k, c in _kernels.LAUNCHES.items() if c}
    _free(dev)

    # timing: every slot at position 512
    rng = np.random.default_rng(seed)
    full_prompts = [[1] + [int(t) for t in rng.integers(3, config.vocab_size, 511)]
                    for _ in range(max_batch)]
    engine.prefill(full_prompts, list(range(max_batch)))
    step_toks = rng.integers(3, config.vocab_size, max_batch)

    def step(i):
        engine.decode_device(torch.tensor(step_toks, device=dev),
                             torch.full((max_batch,), 512 + i, device=dev))

    for i in range(2):
        step(i)
    _sync(dev)
    walls = []
    for i in range(timed_steps):
        t0 = time.perf_counter()
        step(i)
        _sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    _kernels.reset_counts()
    step(0)
    _sync(dev)
    out["step_launches"] = {k: n for k, n in _kernels.LAUNCHES.items() if n}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(4):
            step(i)
        _sync(dev)
        traced = (time.perf_counter() - t0) * 1e3 / 4
    ev = _kernel_events(prof)
    out["step_host_ms"] = walls
    out["step_traced_host_ms"] = traced
    out["step_device_ms"] = _busy_us(ev) / 1e3 / 4
    out["step_collective_host_ms"] = _cpu_busy_ms(prof, ("allreduce", "all_reduce",
                                                         "allgather", "all_gather")) / 4
    out["step_kernels"] = len(ev) / 4
    return out

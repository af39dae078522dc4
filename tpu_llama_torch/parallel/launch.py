"""Start the ranks of a tensor-parallel run, and the rank entry points.

``RankPool(mesh_config, backend=..., device=...)`` starts one process per
rank with ``torch.multiprocessing``'s spawn method, joins them to a process
group at ``tcp://127.0.0.1:<a free port>`` (``"gloo"`` on the CPU or for
ranks that share one card, ``"nccl"`` for one rank per card), builds each
rank's ``Mesh`` on ``device`` (default the card: ``make_mesh`` raises where
there is none) and keeps the ranks alive across calls (JAX's single
controller): each call, with its arguments, goes to every rank and returns
rank 0's result (or every rank's); a rank that fails, or a call that
outlasts its ``timeout``, ends every rank and raises.  The children import
torch and this package only: a call's function is a function of this
module (or of another module of the package).  ``run(fn, mesh_config,
args, backend=...)`` is one such call of ``fn(mesh, *args)`` on a pool of
its own, every rank's result in rank order.
``MeshEngine`` is an ``Engine``-shaped controller over a pool: each rank builds
the same engine on its shards, and every engine call goes to every rank, so
``ContinuousBatcher``, ``LlamaServer`` and the CLI run unchanged over a
mesh.  ``dryrun_multichip(n)`` starts n ranks on a (dp, tp) mesh and runs
one sharded prefill and decode on tiny shapes.

The entry points below drive the port's TP paths and the sharded engine
from a seed: the tests (on the CPU, against the JAX package's results
computed in the test process) and ``chip_smoke.py`` (on the card) call
them.  Every rank builds the same full weights from the seed, keeps its
shard, and runs the same program on the same inputs (SPMD).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from multiprocessing.connection import wait as mp_wait

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
from tpu_llama_torch.parallel.sharding import shard_params, shard_params_spmd
from tpu_llama_torch.parallel.spmd import (
    spmd_forward_decode,
    spmd_forward_prefill,
    spmd_prefill_chunked_rows,
)
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


def default_backend(world: int, device) -> str:
    """``"nccl"`` where each rank can have a card of its own, else
    ``"gloo"`` (the CPU, or ranks that share a card, which NCCL refuses)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _rank_device(device, backend: str, rank: int):
    """Rank ``rank``'s device: on NCCL, card ``rank`` where ``device`` names
    no card."""
    dev = torch.device("cuda" if device is None else device)
    if backend == "nccl" and dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device(rank)
        return torch.device("cuda", rank)
    return dev


def _host(obj):
    """``obj`` with every tensor as a numpy array (what crosses a pipe)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _pool_child(rank: int, world: int, address: str, backend: str, mesh_config: MeshConfig,
                device, threads: int, conn) -> None:
    """A pool rank: joins the group, then runs each call it is sent on its
    ``state`` (its mesh, and whatever the calls keep there) until told to
    stop; it answers every call, with the result on rank 0 only unless the
    call gathers every rank's."""
    try:
        torch.set_num_threads(threads)
        init_distributed(address, world, rank, backend)
        state = {"mesh": make_mesh(mesh_config, _rank_device(device, backend, rank))}
        conn.send(("ok", None))
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            fn, args, kw, gather = msg[1:]
            out = fn(state, *args, **kw)
            conn.send(("ok", _host(out) if rank == 0 or gather else None))
        dist.barrier()
        dist.destroy_process_group()
        conn.send(("ok", None))
    except BaseException:
        try:
            conn.send(("err", traceback.format_exc()))
        finally:
            raise SystemExit(1)


class RankPool:
    """One spawned process per rank of a ``mesh_config`` mesh, kept alive
    across calls.  ``call(fn, *args)`` runs ``fn(state, *args)`` on every
    rank (``fn`` a module-level function of the package; ``state`` a dict
    per rank holding its ``"mesh"``) and returns rank 0's result, tensors
    as numpy (``gather=True``: every rank's, in rank order).  A rank that
    raises or dies, or a call past ``timeout`` seconds, ends every rank and
    raises RuntimeError (TimeoutError): nothing outlives the failure.  ``backend`` None: ``default_backend``."""

    def __init__(self, mesh_config: MeshConfig, *, backend: str | None = None, device=None,
                 timeout: float = 600.0, threads: int = 1):
        self.mesh_config = mesh_config
        world = mesh_config.n_devices
        self.backend = backend or default_backend(world, device)
        self.timeout = timeout
        ctx = mp.get_context("spawn")
        address = f"tcp://127.0.0.1:{free_port()}"
        self._conns, self.procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_pool_child, args=(r, world, address, self.backend,
                                                      mesh_config, device, threads, child),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self.procs.append(p)
        self._wait("start")

    @property
    def alive(self) -> bool:
        return bool(self.procs) and all(p.is_alive() for p in self.procs)

    def _end(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join()
        for c in self._conns:
            c.close()
        self.procs, self._conns = [], []

    def _wait(self, what: str) -> list:
        """Every rank's answer to the last message: their results."""
        deadline = time.monotonic() + self.timeout
        answers = [None] * len(self.procs)
        try:
            while any(a is None for a in answers):
                left = [r for r, a in enumerate(answers) if a is None]
                ready = mp_wait([self._conns[r] for r in left]
                                + [self.procs[r].sentinel for r in left],
                                timeout=max(0.0, deadline - time.monotonic()))
                if not ready:
                    raise TimeoutError(f"{what}: the ranks ran past {self.timeout} s")
                for r in left:
                    if self._conns[r].poll():
                        answers[r] = self._conns[r].recv()
                        if answers[r][0] == "err":
                            raise RuntimeError(f"{what} failed on rank {r}:\n{answers[r][1]}")
                    elif not self.procs[r].is_alive():
                        raise RuntimeError(f"{what}: rank {r} died (exit code "
                                           f"{self.procs[r].exitcode})")
        except BaseException:
            self._end()
            raise
        return [a[1] for a in answers]

    def call(self, fn, *args, gather: bool = False, **kw):
        if not self.alive:
            raise RuntimeError("the rank pool has ended")
        for c in self._conns:
            c.send(("call", fn, args, kw, gather))
        out = self._wait(getattr(fn, "__name__", str(fn)))
        return out if gather else out[0]

    def close(self) -> None:
        """Stop every rank (each leaves its process group) and join them."""
        if self.alive:
            try:
                for c in self._conns:
                    c.send(("stop",))
                self._wait("stop")
            except (RuntimeError, TimeoutError, OSError):
                pass
        self._end()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "procs", None):
            self._end()


def _with_mesh(state, fn, args):
    return fn(state["mesh"], *args)


def run(fn, mesh_config: MeshConfig, args=(), *, backend: str, device=None,
        timeout: float = 120.0, threads: int = 1) -> list:
    """``fn(mesh, *args)`` on every rank of a ``mesh_config`` mesh (one
    ``RankPool`` call); returns their results in rank order, tensors as
    numpy.  Raises RuntimeError with the failing rank's traceback, or
    TimeoutError after ``timeout`` seconds; either way no rank outlives the
    call."""
    with RankPool(mesh_config, backend=backend, device=device, timeout=timeout,
                  threads=threads) as pool:
        return pool.call(_with_mesh, fn, tuple(args), gather=True)


# ---------------------------------------------------------------------------
# MeshEngine: one process driving the ranks of a mesh engine
# ---------------------------------------------------------------------------

_SNAP_IDS = itertools.count()
_ENGINE_INFO = ("max_batch", "seq_len", "config", "precision", "decode_attn", "decode_fused",
                "prefill_attn", "tp_fused", "spmd")


def _engine_build(state, build, args, kw):
    """Rank side of ``MeshEngine``: ``build(mesh, *args, **kw)`` -> the
    rank's Engine, kept; returns its public settings."""
    eng = state["engine"] = build(state["mesh"], *args, **kw)
    state["snaps"] = {}
    return {k: getattr(eng, k) for k in _ENGINE_INFO}


@dataclasses.dataclass
class _Tensor:
    """A tensor an engine method returned, as its host array (the
    controller hands it back as a CPU tensor)."""

    array: np.ndarray


def _engine_call(state, name, args, kw):
    """Rank side of ``MeshEngine``'s methods: ``engine.<name>(*args, **kw)``,
    snapshots kept on the rank under an id that stands for them."""
    eng = state["engine"]
    if name == "snapshot_slot":
        snap = eng.snapshot_slot(*args, **kw)
        if snap is None:
            return None
        i = next(_SNAP_IDS)
        state["snaps"][i] = snap
        return {"length": snap["length"], "mesh_snap": i}
    if name in ("restore_slot", "release_snapshot"):
        args = list(args)
        k = 1 if name == "restore_slot" else 0
        handle = args[k]
        if handle is None:
            return None
        args[k] = (state["snaps"][handle["mesh_snap"]] if name == "restore_slot"
                   else state["snaps"].pop(handle["mesh_snap"], None))
    out = getattr(eng, name)(*args, **kw)
    return _Tensor(out.detach().cpu().numpy()) if isinstance(out, torch.Tensor) else out


def _engine_rows(x):
    """Controller-side arguments as host data: CPU tensors (and lists of them)
    become numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, list) and x and isinstance(x[0], torch.Tensor):
        return [t.detach().cpu().numpy() for t in x]
    return x


class MeshEngine:
    """An ``Engine``-shaped controller of a mesh engine: a ``RankPool`` whose
    ranks each build ``build(mesh, *args, **kw)`` (a module-level function
    returning an ``Engine`` on the rank's shards: ``Engine(mesh)`` or
    ``Engine(mesh, tp_fused=True)``).  Every method of ``Engine`` is
    forwarded: the call, with its host arguments, goes to every rank and
    rank 0's result comes back on the host (numpy, or a CPU tensor where
    the Engine returns a tensor); ``device`` is the CPU.  Snapshots stay on
    the ranks: ``snapshot_slot`` returns a handle that ``restore_slot`` and
    ``release_snapshot`` take.  The settings of rank 0's engine
    (``max_batch``, ``seq_len``, ``config``, ``decode_attn``, ``tp_fused``
    ...) are attributes.  ``close`` (or ``with``) ends the ranks."""

    device = torch.device("cpu")
    pool = None  # a mesh engine's cache is dense

    def __init__(self, build, args=(), kw=None, *, mesh_config: MeshConfig,
                 backend: str | None = None, device=None, timeout: float = 600.0,
                 threads: int = 1):
        if torch.device("cuda" if device is None else device).type == "cuda":
            from tpu_llama_torch.ops import _kernels

            _kernels.build()  # once here, not once a rank
        self.ranks = RankPool(mesh_config, backend=backend, device=device, timeout=timeout,
                              threads=threads)
        self.mesh_config = mesh_config
        self.__dict__.update(self.ranks.call(_engine_build, build, args, kw or {}))

    def __getattr__(self, name: str):
        from tpu_llama_torch.runtime.engine import Engine

        if name.startswith("_") or not callable(getattr(Engine, name, None)):
            raise AttributeError(f"{type(self).__name__} has no attribute {name!r}")

        def method(*args, **kw):
            out = self.ranks.call(_engine_call, name, tuple(_engine_rows(a) for a in args),
                                  {k: _engine_rows(v) for k, v in kw.items()})
            return torch.from_numpy(out.array) if isinstance(out, _Tensor) else out

        method.__name__ = name
        return method

    def run(self, fn, *args, **kw):
        """``fn(state, *args, **kw)`` on every rank (``state["engine"]`` its
        engine, ``state["mesh"]`` its mesh); rank 0's result."""
        return self.ranks.call(fn, *args, **kw)

    def close(self) -> None:
        self.ranks.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
# the sharded engine (parallel.spmd) on the ranks
# ---------------------------------------------------------------------------


def spmd_params(mesh, config: ModelConfig, seed: int, quant: str | None = None,
                group_size: int | None = None, fuse: bool = False):
    """This rank's ``shard_params_spmd`` shard of ``make_random_weights(
    config, seed)`` (optionally ``fuse_projections`` first, then
    ``quantize_params(mode=quant)``)."""
    params = params_from_raw(make_random_weights(config, seed=seed), device="cpu")
    if fuse:
        params = fuse_projections(params)
    if quant is not None:
        params = quantize_params(params, group_size=group_size, mode=quant)
    return shard_params_spmd(params, mesh)


def _arrays(cache) -> dict:
    return {n: getattr(cache, n).float().cpu().numpy() for n in cache.arrays}


def spmd_decode_roll(mesh, config: ModelConfig, seed: int, tokens, steps: int, kv=None,
                     quant: str | None = None, group_size: int | None = None, **kw) -> dict:
    """``steps`` sharded decode steps (``spmd_forward_decode``) on a fresh
    local cache (``kv`` its dtype, default float32): step p feeds ``tokens +
    p`` at position p (tests/test_sharding.py's roll).  ``kw`` goes to the
    step.  Returns every step's logits [B, V] and this rank's cache
    arrays (f32), as numpy."""
    params = spmd_params(mesh, config, seed, quant, group_size)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=mesh.device)
    B = toks.shape[0]
    cache = _local_cache(config, mesh, B, kv)
    out = {"logits": []}
    for p in range(steps):
        logits, cache = spmd_forward_decode(params, cache, toks + p,
                                            torch.full((B,), p, device=mesh.device), config,
                                            mesh, **kw)
        out["logits"].append(logits.cpu().numpy())
    out["cache"] = _arrays(cache)
    return out


def spmd_prefill_case(mesh, config: ModelConfig, seed: int, tokens, lengths, kv=None,
                      quant: str | None = None, group_size: int | None = None,
                      suffix=None, suffix_lengths=None, **kw) -> dict:
    """``spmd_forward_prefill`` of ``tokens`` [B, T] at start 0 (all
    positions' logits) on a fresh local cache, then, with ``suffix`` [B, T2],
    its continuation at start_pos = T (last-token logits at
    ``suffix_lengths``).  Returns the logits and this rank's cache arrays,
    as numpy."""
    params = spmd_params(mesh, config, seed, quant, group_size)
    dev = mesh.device
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=dev)
    B, T = toks.shape
    cache = _local_cache(config, mesh, B, kv)
    n = torch.as_tensor(np.asarray(lengths), dtype=torch.long, device=dev)
    logits, cache = spmd_forward_prefill(params, cache, toks, torch.zeros(B, dtype=torch.long),
                                         n, config, mesh, logits_mode="all", **kw)
    out = {"prefill": logits.cpu().numpy()}
    if suffix is not None:
        sfx = torch.as_tensor(np.asarray(suffix), dtype=torch.long, device=dev)
        logits, cache = spmd_forward_prefill(
            params, cache, sfx, torch.full((B,), T, dtype=torch.long),
            torch.as_tensor(np.asarray(suffix_lengths), dtype=torch.long, device=dev), config,
            mesh, logits_mode="last", **kw)
        out["continued"] = logits.cpu().numpy()
    out["cache"] = _arrays(cache)
    return out


def spmd_chunked_case(mesh, config: ModelConfig, seed: int, tokens, lengths, chunk: int,
                      kv=None, quant: str | None = None, **kw) -> dict:
    """``spmd_prefill_chunked_rows`` of ``tokens`` [B, T] (dp = 1: every row
    is this rank's) in chunks of ``chunk`` on a fresh local cache.  Returns
    the next-token logits and this rank's cache arrays, as numpy."""
    params = spmd_params(mesh, config, seed, quant)
    toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=mesh.device)
    cache = _local_cache(config, mesh, toks.shape[0], kv)
    logits, cache = spmd_prefill_chunked_rows(
        params, cache, toks, torch.as_tensor(np.asarray(lengths), dtype=torch.long), config,
        mesh, chunk=chunk, **kw)
    return {"logits": logits.cpu().numpy(), "cache": _arrays(cache)}


def build_spmd_engine(mesh, config: ModelConfig, seed: int, quant: str | None = None,
                      fuse: bool = False, **engine_kw):
    """``Engine(mesh=mesh)`` on this rank's ``spmd_params`` shard."""
    from tpu_llama_torch.runtime.engine import Engine

    return Engine(spmd_params(mesh, config, seed, quant, fuse=fuse), config, mesh=mesh,
                  device=mesh.device, **engine_kw)


def build_tp_engine(mesh, config: ModelConfig, seed: int, **engine_kw):
    """``Engine(mesh=mesh, tp_fused=True)`` on this rank's ``tp_params``
    shard (``fuse_projections(tp=...)`` W8A8 weights)."""
    from tpu_llama_torch.runtime.engine import Engine

    return Engine(tp_params(mesh, config, seed, fuse=True, quant="w8a8"), config, mesh=mesh,
                  tp_fused=True, **engine_kw)


def serve_waves(engine, waves, prefix_cache_size: int = 0, emit: bool = False,
                max_chunk: int = 1) -> dict:
    """A ``ContinuousBatcher`` on ``engine`` serving greedy requests ((prompt
    tokens without BOS, steps) pairs) in ``waves``: each wave's requests
    submitted in order and run to the end before the next wave's (so a later
    wave finds an earlier one's prompts in the prefix cache); ``emit``: each
    request records what its ``on_token`` callback saw.  Returns the streams
    (in submission order), what was emitted and the prefix hits."""
    from tpu_llama_torch.runtime.scheduler import ContinuousBatcher, Request

    emitted = []
    batcher = ContinuousBatcher(engine, prefix_cache_size=prefix_cache_size,
                                max_chunk=max_chunk)
    reqs = []
    for wave in waves:
        for p, steps in wave:
            i = len(reqs)
            cb = (lambda tok, i=i: emitted.append((i, tok))) if emit else None
            reqs.append(Request(prompt_tokens=list(p), steps=steps, temperature=0.0,
                                on_token=cb))
            batcher.submit(reqs[-1])
        batcher.run()
    return {"streams": [r.out_tokens for r in reqs], "emitted": emitted,
            "prefix_hits": batcher.prefix_hits}


def mesh_serve(mesh, config: ModelConfig, seed: int, requests, max_batch: int,
               tp_fused: bool = False, quant: str | None = None, kv_dtype="float32",
               prefix_cache_size: int = 0, all_logits=None, **engine_kw) -> dict:
    """A mesh engine on every rank (the sharded one, or ``tp_fused``'s),
    each rank's ``ContinuousBatcher`` serving ``requests`` (``serve_waves``;
    rank 0 alone emits), then ``all_logits`` ((prompt, slot)) through
    ``prefill_with_all_logits`` and ``prefill``.  Returns the streams,
    emitted tokens, prefix hits, the all-position logits and the
    admission's last-token logits of that prompt."""
    build = build_tp_engine if tp_fused else build_spmd_engine
    kw = {} if tp_fused else {"quant": quant}
    engine = build(mesh, config, seed, max_batch=max_batch, kv_dtype=kv_dtype, **kw,
                   **engine_kw)
    out = serve_waves(engine, [requests], prefix_cache_size, emit=mesh.rank == 0)
    if all_logits is not None:
        out["all_logits"] = engine.prefill_with_all_logits(*all_logits)
        out["last_logits"] = engine.prefill([all_logits[0]], [all_logits[1]])[0]
    return out


def build_card_spmd_engine(mesh, config: ModelConfig, seed: int, **engine_kw):
    """``Engine(mesh=mesh)`` on this rank's ``shard_params_spmd`` shard of
    ``random_quant_params(config, seed, fuse=True)`` drawn on the card (the
    weights every rank and the single-device engine draw alike) in the
    unfused layouts (``unfuse_projections``)."""
    from tpu_llama_torch.models.llama import unfuse_projections
    from tpu_llama_torch.runtime.engine import Engine

    full = random_quant_params(config, seed=seed, fuse=True, device=mesh.device)
    params = shard_params_spmd(unfuse_projections(full, config), mesh)
    del full
    _free(mesh.device)
    return Engine(params, config, mesh=mesh, **engine_kw)


def kernel_counts(state, reset: bool = False) -> dict:
    """This rank's kernel launches and plain-version calls since the last
    reset (nonzero ones); ``reset`` zeroes them after reading."""
    from tpu_llama_torch.ops import _kernels

    out = {"launches": {k: n for k, n in _kernels.LAUNCHES.items() if n},
           "plain": {k: n for k, n in _kernels.PLAIN_CALLS.items() if n}}
    if reset:
        _kernels.reset_counts()
    return out


def probe_digest(state, prompts, steps: int) -> dict:
    """``probe`` of the rank's engine, and every rank's SHA-256 of its
    logits' bytes (gathered over the whole group): equal digests, equal
    logits bit for bit."""
    out = probe(state["engine"], prompts, steps)
    h = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes()
                                for a in [out["prefill"], *out["decode"]])).hexdigest()
    out["digests"] = [None] * dist.get_world_size()
    dist.all_gather_object(out["digests"], h)
    return out


def engine_step_reading(state, seed: int, timed_steps: int, pos: int = 512) -> dict:
    """``step_reading`` of the rank's engine (rank 0's is returned)."""
    return step_reading(state["engine"], seed, timed_steps, pos)


def fail_on_rank(state, rank: int) -> int:
    """A pool call that raises on rank ``rank`` alone (the others go on to
    a collective that never completes): the controller's failure path."""
    mesh = state["mesh"]
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return mesh.rank


def pool_pids(state) -> int:
    return os.getpid()


def dryrun_multichip(n_devices: int, device=None, backend: str | None = None,
                     timeout: float = 300.0) -> list:
    """Start ``n_devices`` ranks on a (dp, tp) mesh (dp = 2 where n is even
    and above 1, tp the rest; __graft_entry__.py:44) and run one sharded
    prefill and decode step (``parallel.spmd``) and one explicit-TP decode
    step (``tp_forward_decode``) on tiny shapes.  On the card unless
    ``device`` says otherwise.  Returns each rank's logits shapes; raises
    where a rank fails or a result is not finite."""
    dp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh_config = MeshConfig(data=dp, model=n_devices // dp)
    world = mesh_config.n_devices
    return run(_dryrun, mesh_config, backend=backend or default_backend(world, device),
               device=device, timeout=timeout)


def _dryrun(mesh) -> dict:
    dp, tp = mesh.size(DATA_AXIS), mesh.size(MODEL_AXIS)
    config = ModelConfig(dim=64 * tp, hidden_dim=128 * tp, n_layers=2, n_heads=2 * tp,
                         n_kv_heads=2 * tp, vocab_size=256 * tp, seq_len=32)
    params = spmd_params(mesh, config, seed=0)
    dev = mesh.device
    B = 2 * dp
    cache = _local_cache(config, mesh, B, None)
    tokens = torch.zeros((B, 8), dtype=torch.long, device=dev)
    lengths = torch.full((B,), 8, dtype=torch.long, device=dev)
    logits, cache = spmd_forward_prefill(params, cache, tokens, torch.zeros(B, dtype=torch.long),
                                         lengths, config, mesh)
    nxt = logits[:, -1].argmax(-1)
    pos = torch.full((B,), 8, dtype=torch.long, device=dev)
    logits2, cache = spmd_forward_decode(params, cache, nxt, pos, config, mesh)
    tp_cache = _local_cache(config, mesh, B, None)
    logits3, _ = tp_forward_decode(tp_params(mesh, config, 0), tp_cache, nxt, pos, config, mesh)
    for name, t in (("prefill", logits), ("decode", logits2), ("tp_decode", logits3)):
        if not torch.isfinite(t).all():
            raise FloatingPointError(f"dryrun_multichip: {name} logits are not finite")
    return {"mesh": (dp, tp), "prefill": tuple(logits.shape), "decode": tuple(logits2.shape),
            "tp_decode": tuple(logits3.shape)}


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
               max_batch: int = 8, seq_len: int = 2048, parity=None, prefix=None) -> dict:
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
    ``timed_steps`` fused decode steps timed (``step_reading``).
    ``parity`` ((config, seed, prompts, steps)) first runs ``tp_parity`` on
    the same mesh; ``prefix`` ((prompt, steps) twice, the second prompt
    extending the first) serves the second request after the first on a
    batcher with a prefix cache (a hit: the TP continuation prefill) and
    alone on a cold engine, before the timing."""
    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.parallel.tp import tp_prefill_into_slots
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

    if prefix is not None:  # a prefix hit against a cold admission of the same request
        engine.cache.zero_()
        hot = serve_waves(engine, [[prefix[0]], [prefix[1]]], prefix_cache_size=4)
        engine.cache.zero_()
        cold = serve_waves(engine, [[prefix[1]]])
        out["prefix"] = dict(hits=hot["prefix_hits"], hot=hot["streams"][-1],
                             cold=cold["streams"][0])
        engine.cache.zero_()
    out.update(step_reading(engine, seed, timed_steps, min(512, seq_len // 2)))
    return out


def step_reading(engine, seed: int, timed_steps: int, pos: int = 512) -> dict:
    """A decode step of ``engine`` with every slot at ``pos``: each slot
    admitted at ``pos`` random tokens, then ``timed_steps`` steps timed one
    by one (host wall, synchronized), one step's kernel launches counted
    (this process's) and four steps traced (device busy ms, kernels, host
    ms inside the collectives), each per step; the admission's wall ms and
    the trace's seconds (the steps and their reading) beside."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_llama_torch.ops import _kernels
    from tpu_llama_torch.profile_serving import _busy_us, _kernel_events

    dev, B, V = engine.device, engine.max_batch, engine.config.vocab_size
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    engine.prefill([[1] + [int(t) for t in rng.integers(3, V, pos - 1)] for _ in range(B)],
                   list(range(B)))
    _sync(dev)
    admit_ms = (time.perf_counter() - t0) * 1e3
    step_toks = rng.integers(3, V, B)

    def step(i):
        engine.decode_device(torch.tensor(step_toks, device=dev),
                             torch.full((B,), pos + i, device=dev))

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
    out = {"step_launches": {k: n for k, n in _kernels.LAUNCHES.items() if n},
           "admit_ms": admit_ms}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    t_trace = time.perf_counter()
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
                                                         "allgather", "all_gather",
                                                         "broadcast")) / 4
    out["step_kernels"] = len(ev) / 4
    out["trace_s"] = time.perf_counter() - t_trace
    return out

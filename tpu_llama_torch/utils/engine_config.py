"""Engine and serving configuration file.

Port of tpu_llama/utils/engine_config.py.  The model's shape comes from the
checkpoint header alone; the engine's deployment knobs (quantization, cache,
batching, serving) load from one JSON file:

    {
      "checkpoint": "model.bin", "tokenizer": "tokenizer.bin",
      "quant": "w8a8", "kv_dtype": "int8", "max_batch": 8,
      "device": "cuda",
      "mesh": {"data": 1, "model": 1},
      "server": {"port": 8000, "request_log": "requests.jsonl",
                 "watchdog_s": 120}
    }

The port adds one key, ``device`` (default the card, ``"cuda"``; ``"cpu"``
runs the plain versions).  A file saved by the JAX package's
``EngineConfig`` loads here unchanged.

A mesh of more than one rank (``"mesh": {"data": 1, "model": 2}``) builds
a ``parallel.launch.MeshEngine``: one process per rank, each holding its
shard of the weights and of the cache, driven from the caller's process
with ``Engine``'s methods, so ``ContinuousBatcher`` and ``LlamaServer`` run
on it unchanged.  Which mesh engine follows JAX's rule
(engine_config.py:84-114, ``tp_fused_rule``).
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class ServerConfig:
    port: int = 8000
    host: str = "127.0.0.1"
    request_log: str | None = None
    watchdog_s: float | None = None


@dataclasses.dataclass
class EngineConfig:
    checkpoint: str = "model.bin"
    tokenizer: str = "tokenizer.bin"
    quant: str | None = None  # None | "int8" (Q8_0, K25) | "w8a8" (K1)
    kv_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"
    max_batch: int = 8
    precision: str = "default"  # "default" | "highest"
    seq_len: int | None = None
    kv_layout: str = "dense"  # "dense" | "paged" (paged implies int8 KV)
    page_size: int = 512
    num_pages: int | None = None  # paged pool size (default: the dense equivalent)
    attn: str = "auto"  # "auto" | "flash" | "flash_dma" | "xla"
    fuse: bool = True  # fused wqkv / w13 layouts
    mesh_data: int = 1
    mesh_model: int = 1
    device: str = "cuda"  # the port's: "cuda" (the card) or "cpu"
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "EngineConfig":
        with open(path) as f:
            raw = json.load(f)
        mesh = raw.pop("mesh", {})
        server = raw.pop("server", {})
        unknown = set(raw) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown engine config keys: {sorted(unknown)}")
        cfg = cls(**raw)
        cfg.mesh_data = int(mesh.get("data", 1))
        cfg.mesh_model = int(mesh.get("model", 1))
        cfg.server = ServerConfig(**server)
        return cfg

    def save(self, path: str | os.PathLike) -> None:
        d = dataclasses.asdict(self)
        d["mesh"] = {"data": d.pop("mesh_data"), "model": d.pop("mesh_model")}
        with open(path, "w") as f:
            json.dump(d, f, indent=1)

    def tp_fused_rule(self, config) -> bool:
        """JAX's rule for the explicit-TP fused engine (engine_config.py:
        84-91): fused layouts, model > 1, data 1, W8A8, a dense cache and
        dim a multiple of 128 x model.  Any other mesh takes the sharded
        engine (GSPMD's single program)."""
        return (self.fuse and self.mesh_model > 1 and self.mesh_data == 1
                and self.quant == "w8a8" and self.kv_layout == "dense"
                and config.dim % (128 * self.mesh_model) == 0)

    def build_engine(self):
        """Load the checkpoint and tokenizer and build the ``Engine`` on
        ``device``, in JAX's order (engine_config.py:73-115): the f32
        weights (``params_from_raw``), ``fuse_projections`` when ``fuse``
        (with a mesh: at model = 1, or tp-interleaved for the ``tp_fused``
        engine), ``quantize_params`` ("int8": Q8_0, "w8a8": W8A8), then the
        engine.  A mesh of more than one rank returns a
        ``parallel.launch.MeshEngine`` whose ranks each build their shard
        (``rank_engine``) on ``device`` (one card a rank over NCCL where
        there are enough, else the ranks share the card over gloo): the
        ``tp_fused`` engine where ``tp_fused_rule`` holds, else the sharded
        one.  Returns (engine, tokenizer)."""
        from tpu_llama_torch.io import Tokenizer, load_checkpoint

        if self.quant not in (None, "int8", "w8a8"):
            raise ValueError(f"unknown quant mode {self.quant}")
        if self.mesh_data * self.mesh_model > 1 and self.kv_layout == "paged":
            raise NotImplementedError("a paged cache under a mesh (no JAX test holds it): "
                                      "ROADMAP queue 1 item 11")
        raw = load_checkpoint(self.checkpoint)
        tok = Tokenizer.load(self.tokenizer, vocab_size=raw.config.vocab_size)
        if self.mesh_data * self.mesh_model > 1:
            from tpu_llama_torch.parallel import MeshConfig
            from tpu_llama_torch.parallel.launch import MeshEngine

            import torch

            del raw
            world = self.mesh_data * self.mesh_model
            engine = MeshEngine(rank_engine, (dataclasses.asdict(self),),
                                mesh_config=MeshConfig(self.mesh_data, self.mesh_model),
                                device=self.device,
                                threads=max(1, torch.get_num_threads() // world))
            return engine, tok
        return self._engine(raw, None), tok

    def _engine(self, raw, mesh):
        """The engine of ``raw`` weights: on ``device`` alone, or this rank's
        shard of ``mesh``."""
        from tpu_llama_torch.models.llama import (fuse_projections, params_from_raw,
                                                  quantize_params)
        from tpu_llama_torch.runtime import Engine

        tp_fused = mesh is not None and self.tp_fused_rule(raw.config)
        fuse = self.fuse and (mesh is None or self.mesh_model == 1 or tp_fused)
        params = params_from_raw(raw, device=self.device if mesh is None else mesh.device)
        if fuse:
            params = fuse_projections(params, tp=self.mesh_model if tp_fused else 1)
        if self.quant is not None:
            params = quantize_params(params, mode="q8_0" if self.quant == "int8" else "w8a8")
        kw = dict(max_batch=self.max_batch, kv_dtype=self.kv_dtype, precision=self.precision,
                  seq_len=self.seq_len, kv_layout=self.kv_layout, page_size=self.page_size,
                  num_pages=self.num_pages, attn=self.attn)
        if mesh is None:
            return Engine(params, raw.config, device=self.device, **kw)
        from tpu_llama_torch.parallel.sharding import shard_params, shard_params_spmd

        params = (shard_params if tp_fused else shard_params_spmd)(params, mesh)
        if mesh.device.type == "cuda":  # the whole weights' blocks, back to the card
            import torch

            torch.cuda.empty_cache()
        return Engine(params, raw.config, mesh=mesh, tp_fused=tp_fused, **kw)


def rank_engine(mesh, fields: dict):
    """A ``MeshEngine`` rank's engine: ``EngineConfig(**fields)``'s
    checkpoint (memory-mapped: the ranks share the host's copy), this
    rank's shard of its weights on ``mesh``, each weight loaded,
    quantized and cut on the rank's device.  Ranks that share one card
    (gloo) load in turns, so that one whole copy of the weights is on it
    at a time."""
    import torch.distributed as dist

    from tpu_llama_torch.io import load_checkpoint

    server = ServerConfig(**fields.pop("server"))
    cfg = EngineConfig(**fields, server=server)
    if not (mesh.backend == "gloo" and mesh.device.type == "cuda"):
        return cfg._engine(load_checkpoint(cfg.checkpoint), mesh)
    for r in range(mesh.config.n_devices):
        if r == mesh.rank:
            engine = cfg._engine(load_checkpoint(cfg.checkpoint), mesh)
        dist.barrier()
    return engine

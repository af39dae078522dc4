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

    def build_engine(self):
        """Load the checkpoint and tokenizer and build the ``Engine`` on
        ``device``, in JAX's order (engine_config.py:73-115): the f32
        weights (``params_from_raw``), ``fuse_projections`` when ``fuse``,
        ``quantize_params`` ("int8": Q8_0, "w8a8": W8A8), then the engine.
        Returns (engine, tokenizer).  A mesh (data or model > 1) raises
        NotImplementedError: the port's tensor-parallel engine runs one
        process per rank (``parallel.launch``), which one call cannot
        build."""
        from tpu_llama_torch.io import Tokenizer, load_checkpoint
        from tpu_llama_torch.models.llama import (fuse_projections, params_from_raw,
                                                  quantize_params)
        from tpu_llama_torch.runtime import Engine

        if self.mesh_data * self.mesh_model > 1:
            raise NotImplementedError(
                f"mesh {self.mesh_data} x {self.mesh_model}: the port's tensor-parallel engine "
                "runs one process per rank (tpu_llama_torch.parallel.launch)")
        if self.quant not in (None, "int8", "w8a8"):
            raise ValueError(f"unknown quant mode {self.quant}")
        raw = load_checkpoint(self.checkpoint)
        tok = Tokenizer.load(self.tokenizer, vocab_size=raw.config.vocab_size)
        params = params_from_raw(raw, device=self.device)
        if self.fuse:
            params = fuse_projections(params)
        if self.quant is not None:
            params = quantize_params(params, mode="q8_0" if self.quant == "int8" else "w8a8")
        engine = Engine(params, raw.config, max_batch=self.max_batch, kv_dtype=self.kv_dtype,
                        precision=self.precision, seq_len=self.seq_len, kv_layout=self.kv_layout,
                        page_size=self.page_size, num_pages=self.num_pages, attn=self.attn,
                        device=self.device)
        return engine, tok

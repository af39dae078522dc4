"""llama2.c v0 (``model.bin``) checkpoint reader and writer.

Port of tpu_llama/io/checkpoint.py.  Binary layout (llama2.ts:112-129):

    28-byte header (7 x i32 LE; ModelConfig.from_header)
    token_embedding_table  (vocab, dim)        f32
    rms_att_weight         (L, dim)            f32
    wq                     (L, dim, dim)       f32   row-major (out, in)
    wk                     (L, kv_dim, dim)    f32
    wv                     (L, kv_dim, dim)    f32
    wo                     (L, dim, dim)       f32
    rms_ffn_weight         (L, dim)            f32
    w1                     (L, hidden, dim)    f32
    w2                     (L, dim, hidden)    f32
    w3                     (L, hidden, dim)    f32
    rms_final_weight       (dim,)              f32
    freq_cis_real          (seq_len, head_dim/2) f32  (precomputed RoPE table)
    freq_cis_imag          (seq_len, head_dim/2) f32
    wcls                   (vocab, dim)        f32   only if not shared_weights

wk / wv are (n_kv_heads * head_dim, dim), llama2.c's general v0 layout.
The tensors stay numpy arrays in the on-disk (out, in) orientation;
``models.llama.params_from_raw`` moves them to the device in the (in, out)
layout.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from tpu_llama_torch.config import HEADER_BYTES, ModelConfig


@dataclasses.dataclass
class RawWeights:
    """Checkpoint tensors exactly as stored on disk (fp32, (out, in) layout)."""

    config: ModelConfig
    token_embedding: np.ndarray  # (vocab, dim)
    rms_att: np.ndarray  # (L, dim)
    wq: np.ndarray  # (L, dim, dim)
    wk: np.ndarray  # (L, kv_dim, dim)
    wv: np.ndarray  # (L, kv_dim, dim)
    wo: np.ndarray  # (L, dim, dim)
    rms_ffn: np.ndarray  # (L, dim)
    w1: np.ndarray  # (L, hidden, dim)
    w2: np.ndarray  # (L, dim, hidden)
    w3: np.ndarray  # (L, hidden, dim)
    rms_final: np.ndarray  # (dim,)
    freq_cis_real: np.ndarray  # (seq_len, head_dim // 2)
    freq_cis_imag: np.ndarray  # (seq_len, head_dim // 2)
    wcls: np.ndarray  # (vocab, dim); aliases token_embedding when shared


def _tensor_specs(c: ModelConfig):
    """(name, shape) pairs in on-disk order."""
    hd2 = c.head_dim // 2
    specs = [
        ("token_embedding", (c.vocab_size, c.dim)),
        ("rms_att", (c.n_layers, c.dim)),
        ("wq", (c.n_layers, c.dim, c.dim)),
        ("wk", (c.n_layers, c.kv_dim, c.dim)),
        ("wv", (c.n_layers, c.kv_dim, c.dim)),
        ("wo", (c.n_layers, c.dim, c.dim)),
        ("rms_ffn", (c.n_layers, c.dim)),
        ("w1", (c.n_layers, c.hidden_dim, c.dim)),
        ("w2", (c.n_layers, c.dim, c.hidden_dim)),
        ("w3", (c.n_layers, c.hidden_dim, c.dim)),
        ("rms_final", (c.dim,)),
        ("freq_cis_real", (c.seq_len, hd2)),
        ("freq_cis_imag", (c.seq_len, hd2)),
    ]
    if not c.shared_weights:
        specs.append(("wcls", (c.vocab_size, c.dim)))
    return specs


def load_checkpoint(path: str | os.PathLike, mmap: bool = True) -> RawWeights:
    """Load a v0 checkpoint; raises ValueError for a truncated file or one
    with trailing floats.  With ``mmap=True`` the tensors are zero-copy
    views onto a read-only memory map: one host-to-device copy in all."""
    with open(path, "rb") as f:
        config = ModelConfig.from_header(f.read(HEADER_BYTES))

    if mmap:
        flat = np.memmap(path, dtype=np.float32, mode="r", offset=HEADER_BYTES)
    else:
        with open(path, "rb") as f:
            f.seek(HEADER_BYTES)
            flat = np.frombuffer(f.read(), dtype=np.float32)

    tensors = {}
    off = 0
    for name, shape in _tensor_specs(config):
        n = int(np.prod(shape))
        if off + n > flat.size:
            raise ValueError(
                f"checkpoint truncated: need {off + n} floats for {name}, have {flat.size}")
        tensors[name] = flat[off:off + n].reshape(shape)
        off += n
    if off != flat.size:
        raise ValueError(f"checkpoint has {flat.size - off} trailing floats")

    if config.shared_weights:
        # llama2.ts:127 -- the classifier aliases the embedding table
        tensors["wcls"] = tensors["token_embedding"]
    return RawWeights(config=config, **tensors)


def write_checkpoint(path: str | os.PathLike, w: RawWeights) -> None:
    """Write a v0 checkpoint (for tests and synthetic models)."""
    c = w.config
    with open(path, "wb") as f:
        f.write(c.to_header())
        for name, shape in _tensor_specs(c):
            arr = np.ascontiguousarray(getattr(w, name), dtype=np.float32)
            if arr.shape != shape:
                raise ValueError(f"{name}: expected {shape}, got {arr.shape}")
            arr.tofile(f)


def make_random_weights(config: ModelConfig, seed: int = 0, scale: float = 0.08) -> RawWeights:
    """Deterministic random weights for tests and synthetic models: the
    numpy ``default_rng(seed)`` stream of the JAX package's function, so the
    arrays are equal for a seed."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    c = config
    hd2 = c.head_dim // 2
    # RoPE tables exactly as llama2.c precomputes them: theta = 10000^(-2i/hd)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, hd2, dtype=np.float64) * 2 / c.head_dim))
    angles = np.arange(c.seq_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    tok = t(c.vocab_size, c.dim)
    return RawWeights(
        config=c,
        token_embedding=tok,
        rms_att=np.abs(t(c.n_layers, c.dim)) + 0.5,
        wq=t(c.n_layers, c.dim, c.dim),
        wk=t(c.n_layers, c.kv_dim, c.dim),
        wv=t(c.n_layers, c.kv_dim, c.dim),
        wo=t(c.n_layers, c.dim, c.dim),
        rms_ffn=np.abs(t(c.n_layers, c.dim)) + 0.5,
        w1=t(c.n_layers, c.hidden_dim, c.dim),
        w2=t(c.n_layers, c.dim, c.hidden_dim),
        w3=t(c.n_layers, c.hidden_dim, c.dim),
        rms_final=np.abs(t(c.dim)) + 0.5,
        freq_cis_real=np.cos(angles).astype(np.float32),
        freq_cis_imag=np.sin(angles).astype(np.float32),
        wcls=tok if c.shared_weights else t(c.vocab_size, c.dim),
    )

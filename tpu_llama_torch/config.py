"""Model configuration (a copy of ``tpu_llama.config``).

Mirrors the reference's 7-int32 checkpoint header (llama2.ts:69-93): the
header fields are ``dim, hidden_dim, n_layers, n_heads, n_kv_heads,
vocab_size, seq_len`` and a *negative* ``vocab_size`` encodes an unshared
classifier matrix (llama2.ts:87-90).  GQA-native: ``n_kv_heads`` takes part
in every shape; v0 checkpoints load with ``n_kv_heads == n_heads``.
"""

from __future__ import annotations

import dataclasses
import struct

HEADER_BYTES = 7 * 4  # 7 little-endian int32s (llama2.ts:428)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    shared_weights: bool = True

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        # llama2.ts:91 (`head_size = dim / n_heads`)
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        """GQA group: queries per kv head."""
        return self.n_heads // self.n_kv_heads

    def __post_init__(self) -> None:
        if self.dim % self.n_heads != 0:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads={self.n_heads} not divisible by n_kv_heads={self.n_kv_heads}"
            )

    # ---- binary header (llama2.c v0) ----
    @classmethod
    def from_header(cls, raw: bytes) -> "ModelConfig":
        """Parse the 28-byte llama2.c v0 header (llama2.ts:80-93)."""
        if len(raw) < HEADER_BYTES:
            raise ValueError(f"header too short: {len(raw)} < {HEADER_BYTES}")
        dim, hidden, n_layers, n_heads, n_kv, vocab, seq = struct.unpack(
            "<7i", raw[:HEADER_BYTES]
        )
        return cls(
            dim=dim,
            hidden_dim=hidden,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            vocab_size=abs(vocab),  # sign trick, llama2.ts:87-90
            seq_len=seq,
            shared_weights=vocab > 0,
        )

    def to_header(self) -> bytes:
        vocab = self.vocab_size if self.shared_weights else -self.vocab_size
        return struct.pack(
            "<7i",
            self.dim,
            self.hidden_dim,
            self.n_layers,
            self.n_heads,
            self.n_kv_heads,
            vocab,
            self.seq_len,
        )


# Known Llama-2 family shapes, for synthetic benchmarking / conversion checks.
LLAMA2_7B = ModelConfig(
    dim=4096, hidden_dim=11008, n_layers=32, n_heads=32, n_kv_heads=32,
    vocab_size=32000, seq_len=2048, shared_weights=False,
)
LLAMA2_13B = ModelConfig(
    dim=5120, hidden_dim=13824, n_layers=40, n_heads=40, n_kv_heads=40,
    vocab_size=32000, seq_len=2048, shared_weights=False,
)
LLAMA2_70B = ModelConfig(
    dim=8192, hidden_dim=28672, n_layers=80, n_heads=64, n_kv_heads=8,
    vocab_size=32000, seq_len=2048, shared_weights=False,
)
STORIES15M = ModelConfig(
    dim=288, hidden_dim=768, n_layers=6, n_heads=6, n_kv_heads=6,
    vocab_size=32000, seq_len=256, shared_weights=True,
)
STORIES110M = ModelConfig(
    dim=768, hidden_dim=2048, n_layers=12, n_heads=12, n_kv_heads=12,
    vocab_size=32000, seq_len=1024, shared_weights=True,
)

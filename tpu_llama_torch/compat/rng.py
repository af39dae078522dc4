"""xorshift64* RNG, bit-identical to the reference (llama2.ts:348-360).

A copy of ``tpu_llama.compat.rng``: seeded host sampling is reproducible
across implementations only if the RNG stream and its f32 conversion match
exactly.

Reference semantics:
  * 64-bit state; update: ``s ^= s>>12; s ^= (s<<25) & 2^64-1; s ^= s>>27``
  * output: bits 32..63 of ``s * 0x2545F4914F6CDD1D`` (llama2.ts:353)
  * ``random_f32``: ``(u32 / 256) / 16777216`` computed in float64 then
    rounded to float32 (llama2.ts:356-360).
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_MULT = 0x2545F4914F6CDD1D


class Xorshift64Star:
    __slots__ = ("state",)

    def __init__(self, seed: int):
        self.state = seed & _M64

    def random_u32(self) -> int:
        s = self.state
        s ^= s >> 12
        s = (s ^ (s << 25)) & _M64
        s ^= s >> 27
        self.state = s
        return ((s * _MULT) >> 32) & 0xFFFFFFFF

    def random_f32(self) -> float:
        """Random float32 in [0, 1) — returns the exact f32 value as a float."""
        return float(np.float32((self.random_u32() / 256.0) / 16777216.0))

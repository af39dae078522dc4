"""Per-channel INT8 weights and per-row INT8 activations (W8A8).

Port of tpu_llama/ops/quant.py:137-321.  Every quantizer here uses the
formula of the JAX package (quant.py:255-263): ``s = absmax / 127``, then
``inv = 1 / s`` (0 where s == 0), then ``q = clip(round(x * inv), -127,
127)`` -- a multiply by the reciprocal, not a division -- with round half
to even (``torch.round``).

One detail decides the bytes: the JAX package quantizes activations and KV
rows inside ``jit`` (and in its Pallas kernel), where XLA's algebraic
simplifier turns ``absmax / 127`` into ``absmax * f32(1/127)``, which can
differ in the last bit; it quantizes weights eagerly, as a true division.
The port does the same in each place, so its int8 bytes and f32 scales
equal the JAX package's as it runs.

No TPU padding: tensors keep their logical shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_llama_torch.ops import _kernels


@dataclasses.dataclass
class ChannelQuantTensor:
    """Per-output-channel symmetric INT8 weights (the W8 of W8A8).

    ``q``: int8 [..., out, in] -- stored K-major, the transpose of the JAX
    package's [..., in, out], because the K1 kernel reads both operands
    contiguous along the contraction.  ``s``: f32 [..., out], one scale per
    output column.  Leading dims (layers) stack.
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def in_features(self) -> int:
        return self.q.shape[-1]

    @property
    def out_features(self) -> int:
        return self.q.shape[-2]

    def layer(self, i: int) -> "ChannelQuantTensor":
        """Layer ``i`` of a stacked tensor, as views (no copy)."""
        return ChannelQuantTensor(q=self.q[i], s=self.s[i])


_RECIP_127 = float(torch.tensor(1.0) / torch.tensor(127.0))  # f32(1/127)


def _absmax_quant(xf: torch.Tensor, dim: int, jitted: bool = True):
    """Symmetric absmax INT8 over ``dim`` of an f32 tensor -> (q, s).
    ``jitted`` picks the scale as the JAX package computes it inside jit
    (``absmax * f32(1/127)``) rather than eagerly (``absmax / 127``)."""
    absmax = xf.abs().amax(dim=dim)
    s = absmax * _RECIP_127 if jitted else absmax / 127.0
    pos = s > 0
    inv = torch.where(pos, torch.ones_like(s) / torch.where(pos, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    q = torch.round(xf * inv.unsqueeze(dim)).clamp_(-127, 127).to(torch.int8)
    return q, s


def quantize_channel(w: torch.Tensor) -> ChannelQuantTensor:
    """w [..., in, out] (the JAX layout) -> per-out-channel INT8, stored
    K-major (quant.py:183)."""
    q, s = _absmax_quant(w.float(), dim=-2, jitted=False)
    return ChannelQuantTensor(q=q.transpose(-1, -2).contiguous(), s=s)


def dequantize_channel(t: ChannelQuantTensor, dtype=torch.float32) -> torch.Tensor:
    """-> [..., in, out], the JAX layout (quant.py:246)."""
    return (t.q.float() * t.s.unsqueeze(-1)).transpose(-1, -2).to(dtype)


def quantize_activations_plain(x: torch.Tensor):
    """Per-token (last-axis) dynamic symmetric INT8 (quant.py:255): returns
    (q int8 [..., IN], s f32 [...]) with x ~= q * s[..., None]."""
    return _absmax_quant(x.float(), dim=-1)


def quantize_activations(x: torch.Tensor):
    """``quantize_activations_plain`` through the K2 kernel on a CUDA tensor
    (every row count: the TPU's > 256-row gate was an XLA memory-placement
    matter, matmul.py:462-468); the plain version on a CPU tensor."""
    if _kernels.on_cpu("K2", x):
        return quantize_activations_plain(x)
    code = _kernels.dtype_code(x.dtype)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    m = x2.shape[0]
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    s = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m and n:
        vec = (n * x2.element_size()) % 16 == 0 and x2.data_ptr() % 16 == 0
        _kernels.launch("K2", x2.data_ptr(), code, q.data_ptr(), s.data_ptr(), m, n,
                        int(vec), _kernels.stream(x2))
    elif m:
        s.zero_()
    return q.reshape(*lead, n), s.reshape(lead)

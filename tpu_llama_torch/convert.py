"""Parameters in and out of plain numpy trees.

The JAX package's ``LlamaParams`` reach the port as nested dicts of numpy
arrays with the same field names (``tok_emb``, ``layers`` -> ``wq`` ...,
``rms_final``, ``wcls``, ``rope_cos``, ``rope_sin``).  A per-channel INT8
weight is a dict ``{"q": int8 [..., in_p, out_p], "s": f32 [..., out_p],
"logical_in": int, "logical_out": int}`` in the JAX layout, where ``in_p``
and ``out_p`` may carry the JAX package's TPU zero padding.
``params_from_numpy`` drops that padding and stores ``q`` K-major
(``[..., out, in]``), as the K1 kernel reads it.  A plain array stays a
dense tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_llama_torch.device import resolve_device
from tpu_llama_torch.models.llama import LayerParams, LlamaParams
from tpu_llama_torch.ops.quant import ChannelQuantTensor

_LAYER_FIELDS = [f.name for f in dataclasses.fields(LayerParams)]
_TOP_FIELDS = ["tok_emb", "rms_final", "wcls", "rope_cos", "rope_sin"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: via f32, exact
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _weight_from_numpy(w, device):
    if not isinstance(w, dict):
        return _tensor(w, device)
    n_in, n_out = int(w["logical_in"]), int(w["logical_out"])
    q = np.asarray(w["q"])[..., :n_in, :n_out]
    s = np.asarray(w["s"])[..., :n_out]
    return ChannelQuantTensor(q=_tensor(np.swapaxes(q, -1, -2), device).contiguous(),
                              s=_tensor(s, device).float())


def _weight_to_numpy(w):
    if not isinstance(w, ChannelQuantTensor):
        t = w.detach().cpu()
        return (t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())
    return {"q": np.ascontiguousarray(np.swapaxes(w.q.cpu().numpy(), -1, -2)),
            "s": w.s.cpu().numpy(), "logical_in": w.in_features,
            "logical_out": w.out_features}


def params_from_numpy(tree: dict, device=None) -> LlamaParams:
    """Nested numpy dict (JAX layout, padding allowed) -> the port's params
    on ``device`` (None = the card)."""
    dev = resolve_device(device)
    lt = tree["layers"]
    layers = LayerParams(**{k: _weight_from_numpy(lt[k], dev) for k in _LAYER_FIELDS})
    top = {k: _weight_from_numpy(tree[k], dev) for k in _TOP_FIELDS}
    return LlamaParams(layers=layers, **top)


def params_to_numpy(params: LlamaParams) -> dict:
    """The inverse: the port's params -> nested numpy dict in the JAX layout
    without padding (bf16 tensors come out as float32 arrays)."""
    out = {k: _weight_to_numpy(getattr(params, k)) for k in _TOP_FIELDS}
    out["layers"] = {k: _weight_to_numpy(getattr(params.layers, k)) for k in _LAYER_FIELDS}
    return out

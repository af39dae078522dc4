"""Parameters, KV caches and checkpoints in and out of plain numpy trees.

The JAX package's ``LlamaParams`` reach the port as nested dicts of numpy
arrays with the same field names (``tok_emb``, ``layers`` -> ``wq`` ...,
``rms_final``, ``wcls``, ``rope_cos``, ``rope_sin``).  A quantized weight
is a dict ``{"q": int8 [..., in_p, out_p], "s": ..., "logical_in": int,
"logical_out": int}`` in the JAX layout: per-channel INT8 (W8A8) when
``s`` is f32 [..., out_p] -- ``params_from_numpy`` drops the JAX package's
TPU zero padding and stores ``q`` K-major ([..., out, in]), as K1 reads
it -- and Q8_0 when ``s`` is f32 [..., in_p / g, out_p] -- both arrays
stored K-major with their padding kept, as K25 reads them.  A plain array
stays a dense tensor.  A KV cache is a dict of ``k`` and ``v`` (fp) or
``k``, ``v``, ``ks``, ``vs`` (INT8); a checkpoint is any object with the
fields of ``io.checkpoint.RawWeights`` (the JAX package's own included).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_llama_torch.config import ModelConfig
from tpu_llama_torch.device import resolve_device
from tpu_llama_torch.io.checkpoint import RawWeights
from tpu_llama_torch.models.llama import (KVCache, LayerParams, LlamaParams, PagedKVCache,
                                          QuantKVCache)
from tpu_llama_torch.ops.quant import ChannelQuantTensor, QuantTensor

_LAYER_FIELDS = [f.name for f in dataclasses.fields(LayerParams)]
_TOP_FIELDS = ["tok_emb", "rms_final", "wcls", "rope_cos", "rope_sin"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: via f32, exact
        return torch.tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(a, device=device)


def _k_major(a, device) -> torch.Tensor:
    return _tensor(np.swapaxes(np.asarray(a), -1, -2), device).contiguous()


def _weight_from_numpy(w, device):
    if not isinstance(w, dict):
        return _tensor(w, device)
    n_in, n_out = int(w["logical_in"]), int(w["logical_out"])
    if np.ndim(w["s"]) == np.ndim(w["q"]):  # Q8_0: group scales [..., in_p / g, out_p]
        return QuantTensor(q=_k_major(w["q"], device), s=_k_major(w["s"], device).float(),
                           logical_in=n_in, logical_out=n_out)
    q = np.asarray(w["q"])[..., :n_in, :n_out]
    s = np.asarray(w["s"])[..., :n_out]
    return ChannelQuantTensor(q=_tensor(np.swapaxes(q, -1, -2), device).contiguous(),
                              s=_tensor(s, device).float())


def _weight_to_numpy(w):
    if isinstance(w, QuantTensor):
        return {"q": np.ascontiguousarray(np.swapaxes(w.q.cpu().numpy(), -1, -2)),
                "s": np.ascontiguousarray(np.swapaxes(w.s.cpu().numpy(), -1, -2)),
                "logical_in": w.logical_in, "logical_out": w.logical_out}
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


def cache_from_numpy(tree: dict, device=None):
    """``{"k", "v"}`` (an fp cache) or ``{"k", "v", "ks", "vs"}`` (INT8) of
    [L, B, KVH, S, hd] (scales [L, B, KVH, S]) numpy arrays -> a ``KVCache``
    or ``QuantKVCache`` on ``device`` (None = the card); with a
    ``"page_table"`` [B, MP] beside INT8 pools [L, P, KVH, ps, hd] (scales
    [L, P, KVH, ps]), a ``PagedKVCache``."""
    dev = resolve_device(device)
    arrays = {n: _tensor(tree[n], dev).contiguous() for n in ("k", "v", "ks", "vs")
              if tree.get(n) is not None}
    if tree.get("page_table") is not None:
        pt = torch.from_numpy(np.asarray(tree["page_table"], np.int32)).to(dev)
        return PagedKVCache(page_table=pt.contiguous(), **arrays)
    return QuantKVCache(**arrays) if "ks" in arrays else KVCache(**arrays)


def cache_to_numpy(cache) -> dict:
    """The inverse of ``cache_from_numpy`` (bf16 values come out as float32
    arrays; a paged cache's page table as int32)."""
    out = {n: _weight_to_numpy(getattr(cache, n)) for n in cache.arrays}
    if isinstance(cache, PagedKVCache):
        out["page_table"] = cache.page_table.cpu().numpy()
    return out


def raw_weights_from(raw) -> RawWeights:
    """A checkpoint's tensors (any object with ``RawWeights``' fields, its
    config any object with ``ModelConfig``'s) -> the port's ``RawWeights``,
    the arrays shared, not copied."""
    cfg = ModelConfig(**{f.name: getattr(raw.config, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    return RawWeights(config=cfg, **{f.name: np.asarray(getattr(raw, f.name))
                                     for f in dataclasses.fields(RawWeights)
                                     if f.name != "config"})

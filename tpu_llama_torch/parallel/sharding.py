"""How the Llama parameters and the KV cache split over the mesh.

Port of tpu_llama/parallel/sharding.py.  JAX describes a layout with
``PartitionSpec``s and lets ``device_put`` place each shard; here each rank
holds its own shard, so a layout is a per-leaf split rule -- the dim that
splits over ``model`` (negative, counted from the end), or None for a leaf
every rank holds whole -- and ``shard_params`` cuts this rank's piece.

Tensor-parallel layout (the port's weights are dense [L, in, out], or
K-major ``ChannelQuantTensor`` q [L, out, in] with s [L, out], or
``QuantTensor`` q [L, out_p, in_p] with s [L, out_p, in_p / g]):

* ``wq/wk/wv``, ``w1/w3`` and ``wcls`` -- column-sharded (heads, the FFN
  hidden dim, the vocab): the out dim, and a scale's out dim with it;
* ``wo``, ``w2`` -- row-sharded on the in dim; a per-channel scale (out)
  is held whole, a Q8_0 scale splits with its groups;
* ``tok_emb`` [V, D] -- vocab-sharded;
* norms, RoPE tables and the [L, 1, 1] stubs of ``fuse_projections`` --
  replicated;
* KV cache [L, B, KVH, S, hd] -- batch over ``data``, kv heads over
  ``model``.

GSPMD's auto-partitioned single-program forward, which these specs feed in
JAX (``jax.jit`` over ``NamedSharding``), has no counterpart here: the port
runs only the explicit TP paths of ``parallel.tp`` (ROADMAP queue 1 item
11).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_llama_torch.models.llama import LayerParams, LlamaParams
from tpu_llama_torch.ops.quant import ChannelQuantTensor, QuantTensor
from tpu_llama_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_COLUMN = ("wq", "wk", "wv", "w1", "w3")
_ROW = ("wo", "w2")


def _column_spec(w):
    if isinstance(w, ChannelQuantTensor):
        return ChannelQuantTensor(q=-2, s=-1)
    if isinstance(w, QuantTensor):
        return QuantTensor(q=-2, s=-2, logical_in=w.logical_in, logical_out=w.logical_out)
    return -1


def _row_spec(w):
    if isinstance(w, ChannelQuantTensor):
        return ChannelQuantTensor(q=-1, s=None)
    if isinstance(w, QuantTensor):
        return QuantTensor(q=-1, s=-1, logical_in=w.logical_in, logical_out=w.logical_out)
    return -2


def _stub(w) -> bool:
    """A ``fuse_projections`` stub [L, 1, 1]: too small to shard."""
    return isinstance(w, torch.Tensor) and w.dim() == 3 and w.shape[-2:] == (1, 1)


def params_pspecs(params: LlamaParams) -> LlamaParams:
    """A LlamaParams-shaped tree of split rules for ``params``: for a dense
    leaf the dim that splits over ``model`` or None, for a quantized one a
    tensor of its kind holding its values' and its scales' rules."""
    lp = params.layers

    def rule(name, w):
        if _stub(w):
            return None
        return _column_spec(w) if name in _COLUMN else _row_spec(w)

    return LlamaParams(
        tok_emb=-2,
        layers=LayerParams(rms_att=None, rms_ffn=None,
                           **{n: rule(n, getattr(lp, n)) for n in _COLUMN + _ROW}),
        rms_final=None,
        wcls=_column_spec(params.wcls),
        rope_cos=None,
        rope_sin=None,
    )


def cache_pspec(cache) -> dict:
    """Each cache array's (dim over ``data``, dim over ``model``): batch and
    kv heads, for values [L, B, KVH, S, hd] and scales [L, B, KVH, S]."""
    return {n: (1, 2) for n in cache.arrays}


def logits_pspec() -> tuple:
    """Logits [B, V]: (dim over ``data``, dim over ``model``)."""
    return (0, 1)


def _piece(t: torch.Tensor, dim, n: int, i: int, device) -> torch.Tensor:
    """Piece ``i`` of ``n`` of ``t`` along ``dim`` (all of it for None),
    contiguous on ``device``."""
    if dim is not None:
        if t.shape[dim] % n:
            raise ValueError(f"a dim of {t.shape[dim]} does not split over {n} ranks")
        t = t.narrow(dim, t.shape[dim] // n * i, t.shape[dim] // n)
    return t.to(device).contiguous()


def _shard_leaf(w, spec, n: int, i: int, device):
    if isinstance(w, ChannelQuantTensor):
        return ChannelQuantTensor(q=_piece(w.q, spec.q, n, i, device),
                                  s=_piece(w.s, spec.s, n, i, device))
    if isinstance(w, QuantTensor):
        q, s = _piece(w.q, spec.q, n, i, device), _piece(w.s, spec.s, n, i, device)
        padded = w.padded_in != w.logical_in or w.padded_out != w.logical_out
        # a padding-free shard is a QuantTensor of its own width; a padded
        # one keeps the global logical widths (JAX's static metadata), which
        # the TP paths find and refuse
        if padded:
            return QuantTensor(q=q, s=s, logical_in=w.logical_in, logical_out=w.logical_out)
        return QuantTensor(q=q, s=s, logical_in=q.shape[-1], logical_out=q.shape[-2])
    return _piece(w, spec, n, i, device)


def shard_params(params: LlamaParams, mesh: Mesh) -> LlamaParams:
    """This rank's shard of full ``params`` (on the host or a card), on
    ``mesh.device``: each leaf cut by ``params_pspecs``."""
    specs = params_pspecs(params)
    n, i = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)

    def cut(w, spec):
        return _shard_leaf(w, spec, n, i, mesh.device)

    lp, ls = params.layers, specs.layers
    return LlamaParams(
        tok_emb=cut(params.tok_emb, specs.tok_emb),
        layers=LayerParams(**{f.name: cut(getattr(lp, f.name), getattr(ls, f.name))
                              for f in dataclasses.fields(LayerParams)}),
        rms_final=cut(params.rms_final, None),
        wcls=cut(params.wcls, specs.wcls),
        rope_cos=cut(params.rope_cos, None),
        rope_sin=cut(params.rope_sin, None),
    )


def shard_cache(cache, mesh: Mesh):
    """This rank's local cache [L, B / dp, KVH / tp, S, hd] of a full one."""
    out = {}
    for n, (d_dim, m_dim) in cache_pspec(cache).items():
        t = getattr(cache, n)
        t = _piece(t, d_dim, mesh.size(DATA_AXIS), mesh.index(DATA_AXIS), t.device)
        out[n] = _piece(t, m_dim, mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS), mesh.device)
    return type(cache)(**out)

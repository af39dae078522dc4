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

``shard_params`` cuts the explicit-TP paths' shards (``parallel.tp``: the
tp-interleaved fused layouts, padding refused there).  GSPMD's
auto-partitioned single program, which the same specs feed in JAX
(``jax.jit`` over ``NamedSharding``), is the sharded engine here
(``parallel.spmd``); its shards come from ``shard_params_spmd``, which cuts
by LOGICAL rows and columns, so that each rank's products are pieces of the
single-device ones:

* a Q8_0 column shard keeps its whole (padded) in dim and its logical out
  columns, re-padded to 128 rows; a Q8_0 row shard keeps whole groups of
  its logical in dim, re-padded to ``kernel_alignment(g)`` -- and where a
  cut would split a group (a shard width that is not a multiple of g), the
  leaf is held whole on every rank and the product runs whole on a
  gathered input, as GSPMD would place it;
* fused layouts (wqkv, w13: ``fuse_projections``' stubs in wk, wv, w3)
  shard only at model = 1, where every rank holds the whole weights.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from tpu_llama_torch.models.llama import LayerParams, LlamaParams
from tpu_llama_torch.ops.quant import ChannelQuantTensor, QuantTensor, kernel_alignment
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


# ---------------------------------------------------------------------------
# the sharded engine's shards (parallel.spmd): logical pieces
# ---------------------------------------------------------------------------


def _span(n_total: int, n: int, i: int) -> tuple[int, int]:
    if n_total % n:
        raise ValueError(f"a dim of {n_total} does not split over {n} ranks")
    return n_total // n * i, n_total // n * (i + 1)


def _padded(t: torch.Tensor, dim: int, to: int) -> torch.Tensor:
    """``t`` zero-padded at the end of ``dim`` (negative) to a multiple of
    ``to``."""
    pad = -t.shape[dim] % to
    if not pad:
        return t
    spec = [0, 0] * (-dim - 1) + [0, pad]
    return F.pad(t, spec)


def _column_piece(w, n: int, i: int, device):
    """Logical output columns [i out / n, (i + 1) out / n) of a weight."""
    if isinstance(w, ChannelQuantTensor):
        lo, hi = _span(w.out_features, n, i)
        return ChannelQuantTensor(q=w.q[..., lo:hi, :].to(device).contiguous(),
                                  s=w.s[..., lo:hi].to(device).contiguous())
    if isinstance(w, QuantTensor):
        lo, hi = _span(w.logical_out, n, i)
        q = _padded(w.q[..., lo:hi, :], -2, 128)  # K25 takes out rows padded to 128
        s = _padded(w.s[..., lo:hi, :], -2, 128)
        return QuantTensor(q=q.to(device).contiguous(), s=s.to(device).contiguous(),
                           logical_in=w.logical_in, logical_out=hi - lo)
    lo, hi = _span(w.shape[-1], n, i)
    return w[..., lo:hi].to(device).contiguous()


def _row_piece(w, n: int, i: int, device):
    """Logical input rows [i in / n, (i + 1) in / n) of a weight; a Q8_0
    weight whose cut would split a quant group is held whole."""
    if isinstance(w, ChannelQuantTensor):
        lo, hi = _span(w.in_features, n, i)
        return ChannelQuantTensor(q=w.q[..., lo:hi].to(device).contiguous(),
                                  s=w.s.to(device).contiguous())
    if isinstance(w, QuantTensor):
        g = w.group_size
        if w.logical_in % n or (w.logical_in // n) % g:
            return _move(w, device)
        lo, hi = _span(w.logical_in, n, i)
        q = _padded(w.q[..., lo:hi], -1, kernel_alignment(g))
        s = _padded(w.s[..., lo // g:hi // g], -1, kernel_alignment(g) // g)
        return QuantTensor(q=q.to(device).contiguous(), s=s.to(device).contiguous(),
                           logical_in=hi - lo, logical_out=w.logical_out)
    lo, hi = _span(w.shape[-2], n, i)
    return w[..., lo:hi, :].to(device).contiguous()


def fused_layouts(params: LlamaParams) -> bool:
    """Whether ``params`` are in ``fuse_projections``' layouts (wk, wv and
    w3 its [L, 1, 1] stubs)."""
    lp = params.layers
    return any(_stub(w) for w in (lp.wk, lp.wv, lp.w3))


def shard_params_spmd(params: LlamaParams, mesh: Mesh) -> LlamaParams:
    """This rank's shard of full ``params`` for the sharded engine
    (``parallel.spmd``, JAX's ``shard_params`` under GSPMD), on
    ``mesh.device``: wq, wk, wv, w1, w3 and wcls by logical output columns,
    wo and w2 by logical input rows (Q8_0 ones that a cut would split into
    part groups held whole), tok_emb by vocab rows, the rest whole.  At
    model = 1 every leaf is held whole, fused layouts included; above it
    fused layouts are refused (their columns interleave q, k and v)."""
    n, i = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    if n == 1:
        return _to_device(params, mesh.device)
    if fused_layouts(params):
        raise ValueError("the sharded engine splits unfused layouts over model > 1: build the "
                         "params without fuse_projections (fused layouts shard at model = 1, or "
                         "through fuse_projections(tp=...) for the tp_fused engine)")
    lp = params.layers
    cols = {f: _column_piece(getattr(lp, f), n, i, mesh.device) for f in _COLUMN}
    rows = {f: _row_piece(getattr(lp, f), n, i, mesh.device) for f in _ROW}
    whole = {f: getattr(lp, f).to(mesh.device) for f in ("rms_att", "rms_ffn")}
    lo, hi = _span(params.tok_emb.shape[0], n, i)
    return LlamaParams(
        tok_emb=params.tok_emb[lo:hi].to(mesh.device).contiguous(),
        layers=LayerParams(**cols, **rows, **whole),
        rms_final=params.rms_final.to(mesh.device),
        wcls=_column_piece(params.wcls, n, i, mesh.device),
        rope_cos=params.rope_cos.to(mesh.device),
        rope_sin=params.rope_sin.to(mesh.device),
    )


def _move(w, device):
    """A leaf, whole, on ``device``."""
    if isinstance(w, ChannelQuantTensor):
        return ChannelQuantTensor(q=w.q.to(device), s=w.s.to(device))
    if isinstance(w, QuantTensor):
        return QuantTensor(q=w.q.to(device), s=w.s.to(device), logical_in=w.logical_in,
                           logical_out=w.logical_out)
    return w.to(device)


def _to_device(params: LlamaParams, device) -> LlamaParams:
    lp = params.layers
    return LlamaParams(
        tok_emb=_move(params.tok_emb, device),
        layers=LayerParams(**{f.name: _move(getattr(lp, f.name), device)
                              for f in dataclasses.fields(LayerParams)}),
        rms_final=_move(params.rms_final, device), wcls=_move(params.wcls, device),
        rope_cos=_move(params.rope_cos, device), rope_sin=_move(params.rope_sin, device))

"""Collective matmul: a ring reduce-scatter interleaved with a row-sharded
product.

Port of tpu_llama/parallel/overlap.py.  A row-sharded projection
``Y = sum_s x_s @ W_s`` computed as one all-reduce serializes the product
and the collective.  Here the output columns split into tp chunks that
accumulate around the ring: at each of the tp - 1 hops every rank adds its
partial for the chunk it receives, then a tiled all-gather replicates the
reduced chunks.  The same partial-sum bracketing per chunk as the JAX ring;
used by ``tp_forward_decode(overlap=True)`` for the wo and w2 projections
on dense weights.  The hops are ``torch.distributed`` point-to-point
sends and receives (``mesh.ring_shift``); launched eagerly, a hop does not
overlap the next chunk's product as XLA's scheduler overlaps JAX's, which
is later work.
"""

from __future__ import annotations

import torch

from tpu_llama_torch.models.llama import dense_matmul
from tpu_llama_torch.parallel.mesh import MODEL_AXIS, Mesh, all_gather, ring_shift


def collective_matmul_rowsharded(x: torch.Tensor, w: torch.Tensor, mesh: Mesh,
                                 precision: str = "highest", axis: str = MODEL_AXIS):
    """``sum_s(x_s @ w_s)`` over ``axis``, replicated: x [B, K_local] this
    rank's slice of the contraction, w [K_local, N] its weight rows (dense).
    Returns [B, N]."""
    tp = mesh.size(axis)
    N = w.shape[-1]
    if N % tp:
        raise ValueError(f"N={N} does not split over tp={tp}")
    chunk = N // tp
    idx = mesh.index(axis)

    def partial_for(c: int) -> torch.Tensor:
        return dense_matmul(x, w[:, c * chunk:(c + 1) * chunk], precision)

    # chunk c starts at rank (c + 1) % tp and accumulates along the ring,
    # ending fully reduced at rank c after tp - 1 hops
    acc = partial_for((idx - 1) % tp)
    for t in range(1, tp):
        acc = ring_shift(acc, mesh, axis)
        acc = acc + partial_for((idx - 1 - t) % tp)
    # rank s now holds reduced chunk s; a tiled all-gather rebuilds [B, N]
    return all_gather(acc, mesh, axis, dim=-1)

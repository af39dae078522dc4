"""The ('data', 'model') process mesh over ``torch.distributed``.

Port of tpu_llama/parallel/mesh.py.  JAX runs one controller over a named
device grid; the port runs SPMD: one process per card (or, for two ranks
sharing one card, per share of it), all running the same program.  A
``Mesh`` here is a small object that each process holds: its rank, its
(data, model) coordinates in the grid -- rank r sits at
(r // model, r % model), JAX's ``reshape(data, model)`` -- and the process
groups of its model axis and its data axis.

* ``data``  -- the batch axis (DP): slots split here;
* ``model`` -- the tensor-parallel axis (TP): heads, the FFN hidden dim and
  the vocab split here.

The backend is the caller's: ``"nccl"`` on the card, ``"gloo"`` on the CPU
(the tests' multi-process runs) and for ranks that share one card, which
NCCL refuses.  Gloo takes CUDA tensors in its all-reduce, all-gather and
broadcast, but not in point-to-point sends and receives: a ``send`` of a
CUDA tensor aborts the process (gloo's "writev: Bad address").  So on a
gloo mesh the ring hop of ``ring_shift`` goes through host memory
(``_p2p_through_host``, which names what it does, and counts each such hop
in ``HOST_STAGED``); nothing is switched behind the caller's back.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tpu_llama_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")
HOST_STAGED = {"ring_shift": 0}  # point-to-point hops staged through host memory


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = 1
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None) -> None:
    """Join this process to the process group: ``coordinator_address`` is
    ``torch.distributed``'s init method (``"tcp://localhost:<port>"``, or
    ``"file://<path>"``), ``num_processes`` the world size and
    ``process_id`` this process's rank; ``backend`` ``"nccl"`` or
    ``"gloo"``.  Nothing tells a process of a cluster, so all four are the
    caller's.  A no-op without an address (a single process that builds
    ``single_device_mesh``)."""
    if coordinator_address is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the world size and this process's rank")
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes,
                            rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) grid.  ``model_group`` and
    ``data_group`` are its axes' process groups (None on a mesh built
    without ``torch.distributed``, where both axes have size 1 and every
    collective is the identity); ``device`` is where its shards live."""

    config: MeshConfig
    rank: int
    data_index: int
    model_index: int
    model_group: object
    data_group: object
    backend: str | None
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.config.data, MODEL_AXIS: self.config.model}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.data_index if axis == DATA_AXIS else self.model_index

    def group(self, axis: str):
        return self.data_group if axis == DATA_AXIS else self.model_group


def make_mesh(mesh_config: MeshConfig | None = None, device=None) -> Mesh:
    """This process's mesh over the initialized process group.  Default:
    every rank on the model axis (TP first, as in JAX).  ``device`` is where
    the shards live (None = the card).  Every rank must call it, in the same
    order as its other group creations: each axis group is made by all
    ranks."""
    if not dist.is_initialized():
        if mesh_config not in (None, MeshConfig(1, 1)):
            raise RuntimeError("a mesh of more than one rank needs init_distributed first")
        return single_device_mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = mesh_config or MeshConfig(data=1, model=world)
    if cfg.n_devices != world:
        raise ValueError(f"mesh {cfg.data} x {cfg.model} needs {cfg.n_devices} ranks, the "
                         f"process group has {world}")
    dp, tp = cfg.data, cfg.model
    model_group = data_group = None
    for d in range(dp):  # every rank makes every group, in one order
        g = _group([d * tp + m for m in range(tp)], world)
        if rank // tp == d:
            model_group = g
    for m in range(tp):
        g = _group([d * tp + m for d in range(dp)], world)
        if rank % tp == m:
            data_group = g
    return Mesh(config=cfg, rank=rank, data_index=rank // tp, model_index=rank % tp,
                model_group=model_group, data_group=data_group, backend=dist.get_backend(),
                device=resolve_device(device))


def _group(ranks: list[int], world: int):
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def single_device_mesh(device=None) -> Mesh:
    """A (1, 1) mesh without ``torch.distributed``: collectives are the
    identity."""
    return Mesh(config=MeshConfig(1, 1), rank=0, data_index=0, model_index=0, model_group=None,
                data_group=None, backend=None, device=resolve_device(device))


# ---------------------------------------------------------------------------
# collectives over one axis of the mesh
# ---------------------------------------------------------------------------


def _p2p_through_host(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a send or receive of ``t`` on ``mesh`` goes through host
    memory: a CUDA tensor on a gloo mesh (ranks sharing one card), which
    gloo's point-to-point transport cannot take."""
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (JAX's ``psum``), on every rank of it:
    a new tensor, ``t`` is left as it was."""
    out = t.clone()
    if mesh.group(axis) is not None:
        dist.all_reduce(out, group=mesh.group(axis))
    return out


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in axis order
    (JAX's tiled ``all_gather``), on every rank of it."""
    group = mesh.group(axis)
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """The ``t`` of the rank at index ``src`` of ``axis`` (this rank's own
    index on the other axis), on every rank of it: ``t`` is overwritten in
    place on the others, and returned."""
    group = mesh.group(axis)
    if group is not None and mesh.size(axis) > 1:
        dist.broadcast(t, src=dist.get_process_group_ranks(group)[src], group=group)
    return t


def ring_shift(t: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """JAX's ``ppermute`` with the ring permutation s -> s + 1: sends ``t``
    to the next rank of ``axis`` and returns what the previous one sent."""
    group = mesh.group(axis)
    n = mesh.size(axis)
    if group is None or n == 1:
        return t
    ranks = dist.get_process_group_ranks(group)
    i = mesh.index(axis)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    staged = _p2p_through_host(mesh, t)
    HOST_STAGED["ring_shift"] += int(staged)
    src = (t.cpu() if staged else t).contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, group=group),
           dist.P2POp(dist.irecv, out, prv, group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device) if staged else out

"""Ranks, the process group and the (data, fsdp, model) mesh.

Counterpart of ``mamba_clip_tpu/parallel/mesh.py``. A port rank is one
process on one device; W ranks are the JAX package's W processes of one
device each (``jax.process_count()`` is the world size): ``--batch-size``
is per rank of the batch axis, lr is scaled by the world size, and the
collectives are ``parallel/collectives.py``'s.

The mesh lays the ranks out data-major, as JAX reshapes its devices to
(data, fsdp, model): rank = (d·F + f)·M + m. The batch is split over data
× fsdp together (the batch index d·F + f), so the M ranks of one batch
index see the same rows. The parameters are placed by
:func:`param_sharding` (JAX's rule, decided on the Flax shapes) and held
by ``parallel/sharding.py``.

Launch: ``torchrun --nproc-per-node N -m mamba_clip_tpu_torch.cli.main ...``
sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`maybe_initialize_distributed` reads them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .collectives import DataAxis, comm_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
BACKENDS = ("nccl", "gloo")


def world_info_from_env() -> Tuple[int, int, int]:
    """(rank, local_rank, world_size) from torchrun's ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE`` (0, 0, 1 when unset)."""
    env = os.environ
    return (int(env.get("RANK", 0)), int(env.get("LOCAL_RANK", 0)),
            int(env.get("WORLD_SIZE", 1)))


def _backend(device: str, backend: Optional[str]) -> str:
    """``--dist-backend`` when it names nccl or gloo, else the device's
    default: nccl for the card, gloo for the CPU. (The JAX package's
    default string ``jax`` means that default.)"""
    if backend in BACKENDS:
        return backend
    return "nccl" if str(device).startswith("cuda") else "gloo"


def maybe_initialize_distributed(device: str = "cuda", backend: Optional[str] = None,
                                 init_method: str = "env://") -> Tuple[int, int, int]:
    """Join the process group that the environment describes, when its
    world is above 1; returns (rank, local_rank, world_size). The decision
    comes from the environment only, and a failure propagates: a half-joined
    world must not train. On the card the process takes ``cuda:<local
    rank>`` before the group is made."""
    rank, local_rank, world = world_info_from_env()
    if world > 1 and not dist.is_initialized():
        if str(device).startswith("cuda"):
            torch.cuda.set_device(local_rank)
        dist.init_process_group(_backend(device, backend), init_method=init_method,
                                rank=rank, world_size=world)
    return rank, local_rank, world


def is_master(state_or_rank) -> bool:
    """Rank 0 writes: logs, results, checkpoints."""
    rank = getattr(state_or_rank, "rank", state_or_rank)
    return int(rank) == 0


@dataclass
class MeshSpec:
    """data × fsdp × model; -1 for data takes every rank."""

    data: int = -1
    fsdp: int = 1
    model: int = 1


@dataclass
class Mesh:
    """The port's mesh over ``data * fsdp * model`` ranks, this process
    being ``rank``. ``groups`` holds the process groups of this rank's
    axes (``batch``, ``fsdp``, ``model``, ``data``); an axis of one rank,
    and a batch axis of every rank, has none (None is the default group)."""

    data: int = 1
    rank: int = 0
    fsdp: int = 1
    model: int = 1
    groups: Dict[str, object] = field(default_factory=dict)

    @property
    def shape(self):
        return {DATA_AXIS: self.data, FSDP_AXIS: self.fsdp, MODEL_AXIS: self.model}

    @property
    def coords(self) -> Tuple[int, int, int]:
        """(d, f, m) of this rank."""
        m = self.rank % self.model
        f = (self.rank // self.model) % self.fsdp
        return self.rank // (self.model * self.fsdp), f, m

    @property
    def sharded(self) -> bool:
        """An fsdp or a model axis above 1."""
        return self.fsdp > 1 or self.model > 1

    def axis(self) -> DataAxis:
        """The batch axis (data × fsdp), for ``collectives.data_axis``: the
        rank's batch index d·F + f among D·F."""
        d, f, _ = self.coords
        return DataAxis(rank=d * self.fsdp + f, world=self.data * self.fsdp,
                        group=self.groups.get("batch"))

    def sub_axis(self, name: str) -> DataAxis:
        """The ``fsdp``, ``model`` or ``data`` axis of this rank: its index
        along it, its size and its group."""
        d, f, m = self.coords
        rank, world = {FSDP_AXIS: (f, self.fsdp), MODEL_AXIS: (m, self.model),
                       DATA_AXIS: (d, self.data)}[name]
        return DataAxis(rank=rank, world=world, group=self.groups.get(name))


def _new_groups(data: int, fsdp: int, model: int, rank: int) -> Dict[str, object]:
    """Every rank makes every group, in one fixed order (``dist.new_group``
    is collective): the batch groups (the data × fsdp ranks of one model
    index), the fsdp groups, the model groups, the data groups (which only the
    fsdp-sharded gradients use). An axis of one rank gets none, and neither
    does a batch axis of every rank."""
    def at(d, f, m):
        return (d * fsdp + f) * model + m

    axes = (
        ("batch", data * fsdp < data * fsdp * model,
         [[at(d, f, m) for d in range(data) for f in range(fsdp)] for m in range(model)]),
        (FSDP_AXIS, fsdp > 1,
         [[at(d, f, m) for f in range(fsdp)] for d in range(data) for m in range(model)]),
        (MODEL_AXIS, model > 1,
         [[at(d, f, m) for m in range(model)] for d in range(data) for f in range(fsdp)]),
        (DATA_AXIS, data > 1 and fsdp > 1,
         [[at(d, f, m) for d in range(data)] for f in range(fsdp) for m in range(model)]),
    )
    groups = {}
    for name, needed, members in axes:
        if not needed:
            continue
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return groups


def create_mesh(spec: Optional[MeshSpec] = None, world: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """The (data, fsdp, model) mesh over ``world`` ranks (the process
    group's, else 1); ``spec.data`` -1 takes what fsdp × model leave. A
    shape that does not cover the world raises JAX's ``ValueError``. Every
    rank must call it with the same spec (it makes the process groups)."""
    spec = spec or MeshSpec()
    inited = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if inited else 1
    if rank is None:
        rank = dist.get_rank() if inited else 0
    denom = spec.fsdp * spec.model
    data = spec.data if spec.data > 0 else world // denom
    if data * denom != world:
        raise ValueError(f"mesh {data}x{spec.fsdp}x{spec.model} != {world} devices")
    groups = _new_groups(data, spec.fsdp, spec.model, rank) if denom > 1 else {}
    return Mesh(data=data, rank=rank, fsdp=spec.fsdp, model=spec.model, groups=groups)


def data_sharding(mesh: Mesh) -> DataAxis:
    """The batch axis: the rows are split over data × fsdp (JAX's
    ``P((data, fsdp))``)."""
    return mesh.axis()


def replicated(mesh: Mesh) -> None:
    """The placement of a replicated leaf: whole on every rank."""
    return None


def param_sharding(mesh: Mesh, module: torch.nn.Module) -> Dict[str, Optional[Tuple[str, int]]]:
    """JAX's ``param_sharding`` on ``module``'s parameters: for each
    state-dict key None (replicated) or (axis, the port's dim). The rule
    reads the Flax shape: a leaf of ndim < 2 is replicated; else, with
    fsdp > 1, Flax's dim 0 is sharded over fsdp where fsdp divides it; else,
    with model > 1, Flax's last dim over model where model divides it; else
    the leaf is replicated. Never both axes on one leaf. The Flax dim maps
    to the port's: a Dense kernel (Flax [in, out], port [out, in]) takes
    port dim 1 for Flax's dim 0 and port dim 0 for its last; a convolution
    (Flax HWIO, port OIHW) port dim 2 and port dim 0; any other leaf has
    one layout on both sides. The AdamW moments follow their parameters."""
    from ..convert import flax_leaf_names

    leaf_names = flax_leaf_names(module)
    out: Dict[str, Optional[Tuple[str, int]]] = {}
    for key, p in module.named_parameters():
        out[key] = None
        if p.ndim < 2:
            continue
        if leaf_names[key] == "kernel":
            shape = tuple(p.shape)[::-1] if p.ndim == 2 else (p.shape[2], p.shape[3],
                                                               p.shape[1], p.shape[0])
            first, last = (1, 0) if p.ndim == 2 else (2, 0)
        else:
            shape, first, last = tuple(p.shape), 0, p.ndim - 1
        if mesh.fsdp > 1 and shape[0] % mesh.fsdp == 0:
            out[key] = (FSDP_AXIS, first)
        elif mesh.model > 1 and shape[-1] % mesh.model == 0:
            out[key] = (MODEL_AXIS, last)
    return out


def local_batch_slice(global_batch: int, rank: int, world: int) -> slice:
    """This rank's contiguous shard of the global batch."""
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def broadcast_object(obj, rank: int = 0):
    """``obj`` as rank ``rank`` has it; identity in a world of one."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=rank, device=comm_device())
    return box[0]


def broadcast_module(module: torch.nn.Module, rank: int = 0) -> None:
    """Every parameter and buffer of ``module`` as rank ``rank`` has it, so
    that the ranks start from one state."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=rank)


def barrier() -> None:
    """Wait for every rank; a no-op in a world of one."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()

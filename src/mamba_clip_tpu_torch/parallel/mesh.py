"""Ranks, the process group and the data-axis mesh.

Counterpart of ``mamba_clip_tpu/parallel/mesh.py``. A port rank is one
process on one device; W ranks are the JAX package's W processes of one
device each (``jax.process_count()`` is the world size): ``--batch-size``
is per rank, the loader splits by rank, lr is scaled by the world size, and
the data axis's collectives are ``parallel/collectives.py``'s.

Launch: ``torchrun --nproc-per-node N -m mamba_clip_tpu_torch.cli.main ...``
sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``; :func:`maybe_initialize_distributed` reads them. Only the
data axis is ported: a mesh with an fsdp or a model axis above 1 raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

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
    """The port's mesh: the data axis over the ranks of the default group
    (its fsdp and model axes are 1: not ported)."""

    data: int = 1
    rank: int = 0

    @property
    def shape(self):
        return {DATA_AXIS: self.data, FSDP_AXIS: 1, MODEL_AXIS: 1}

    def axis(self) -> DataAxis:
        """The data axis, for ``collectives.data_axis``."""
        return DataAxis(rank=self.rank, world=self.data)


def create_mesh(spec: Optional[MeshSpec] = None, world: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """The data-axis mesh over ``world`` ranks (the process group's, else
    1). An fsdp or model axis above 1 raises: only the data axis is
    ported."""
    spec = spec or MeshSpec()
    if spec.fsdp > 1 or spec.model > 1:
        raise NotImplementedError(
            f"mesh fsdp={spec.fsdp} model={spec.model}: the fsdp and model axes are not "
            "ported yet (ROADMAP.md, Queue 1, item 8 'Parallel layers')")
    inited = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if inited else 1
    if rank is None:
        rank = dist.get_rank() if inited else 0
    data = spec.data if spec.data > 0 else world
    if data != world:
        raise ValueError(f"mesh data={data} != {world} ranks")
    return Mesh(data=data, rank=rank)


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

"""Ranks, the (data, fsdp, model) mesh, its collectives and the sharded
state."""

from .mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    MeshSpec,
    broadcast_object,
    create_mesh,
    data_sharding,
    is_master,
    local_batch_slice,
    maybe_initialize_distributed,
    param_sharding,
    replicated,
    world_info_from_env,
)

__all__ = [
    "DATA_AXIS", "FSDP_AXIS", "MODEL_AXIS", "MeshSpec", "broadcast_object",
    "create_mesh", "data_sharding", "is_master", "local_batch_slice",
    "maybe_initialize_distributed", "param_sharding", "replicated", "world_info_from_env",
]

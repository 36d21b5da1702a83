"""The data axis across processes: ranks, the mesh and its collectives."""

from .mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    MeshSpec,
    broadcast_object,
    create_mesh,
    is_master,
    local_batch_slice,
    maybe_initialize_distributed,
    world_info_from_env,
)

__all__ = [
    "DATA_AXIS", "FSDP_AXIS", "MODEL_AXIS", "MeshSpec", "broadcast_object",
    "create_mesh", "is_master", "local_batch_slice", "maybe_initialize_distributed",
    "world_info_from_env",
    # not ported yet: data_sharding, param_sharding and replicated, the
    # placements of the fsdp and model axes (ROADMAP.md, Queue 1, item 8a)
]

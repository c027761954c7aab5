"""Distribution: mesh plumbing, guarded shim, sharded-buffer ops.

JAX equivalent of ``torchebm/distributed.py`` + the FSDP2 path; see
``parallel/mesh.py`` for the axis conventions.
"""

from .buffer import shard_replay_buffer, shuffle_sharded
from .mesh import (
    batch_sharding,
    fsdp_shard_params,
    init_distributed,
    local_shard_bounds,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from .shim import (
    all_gather_cat,
    broadcast_object,
    get_rank,
    get_world_size,
    is_distributed,
    psum_mean,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "fsdp_shard_params",
    "init_distributed",
    "local_shard_bounds",
    "is_distributed",
    "get_rank",
    "get_world_size",
    "all_gather_cat",
    "broadcast_object",
    "psum_mean",
    "shard_replay_buffer",
    "shuffle_sharded",
]

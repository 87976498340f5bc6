"""Data parallelism over torch.distributed (the collectives module).

Port of the reference package's `parallel/`: one data mesh over every
device, each rank holding its rows of the global batch, replicated
parameters and summed gradients. See `parallel/mesh.py`.
"""

from outdoor_nerf_depth_torch.parallel.mesh import (
    Mesh,
    active,
    all_gather_rows,
    all_reduce_sum_,
    barrier,
    broadcast_,
    init_from_env,
    make_mesh,
    put_replicated,
    rank,
    row_shard,
    shard_batch,
    shutdown,
    world,
)

__all__ = [
    "Mesh",
    "active",
    "all_gather_rows",
    "all_reduce_sum_",
    "barrier",
    "broadcast_",
    "init_from_env",
    "make_mesh",
    "put_replicated",
    "rank",
    "row_shard",
    "shard_batch",
    "shutdown",
    "world",
]

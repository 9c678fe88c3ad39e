"""Data-parallel and fsdp training over ``torch.distributed`` (counterpart of
``stain2stain_tpu/parallel``): process-group start-up, the (data, fsdp)
mesh, per-rank batch rows and global draws, and the sharded optimizer."""

from .distributed import host_barrier, maybe_initialize_distributed, process_count, process_index
from .mesh import (
    batch_sharding,
    chunk_sharding,
    create_mesh,
    draw_rows,
    param_shardings,
    replicated_sharding,
    shard_batch,
    shard_chunk,
    sharded_generator,
)
from .zero import ShardedOptimizer

__all__ = [
    "batch_sharding",
    "chunk_sharding",
    "shard_chunk",
    "create_mesh",
    "param_shardings",
    "replicated_sharding",
    "shard_batch",
    "maybe_initialize_distributed",
    "host_barrier",
    "process_index",
    "process_count",
    "draw_rows",
    "sharded_generator",
    "ShardedOptimizer",
]

"""The (data, fsdp) device mesh, parameter placements and per-rank batch rows
(counterpart of ``stain2stain_tpu/parallel/mesh.py``).

One process per device: rank ``r`` of ``W`` holds rows ``r::W`` of every
global batch, the strided slice the JAX loader hands each host
(``data/base.py:161-180``). Both mesh dims split the batch, as JAX's
``P(("data", "fsdp"))`` does; ``fsdp`` also shards the optimizer's moments
(:class:`~.zero.ShardedOptimizer`). Placements are DTensor's ``Shard`` and
``Replicate``, one per mesh dim.

Random draws made for a batch are made for the *global* batch and sliced the
same way (:func:`draw_rows`): a W-rank step then draws what the one-process
step on the same global batch draws, which is what JAX's global arrays give.
Sums over the batch that a loss, a metric or a BatchNorm normalizes by
(Dice, the ROI means, the cross-entropy's valid pixels, the BatchNorm
statistics) are global inside :func:`sharded_batch` (:func:`batch_sum`), as
they are under JAX's ``jit``; a mean over equal slices needs no sum, since
the ranks' means are averaged (DDP for gradients, the trainer for metrics).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterable, Iterator, Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from .distributed import is_initialized, process_count, process_index

MESH_DIMS = ("data", "fsdp")


def _check_fsdp(n: int, fsdp: int) -> None:
    if fsdp < 1 or n % fsdp != 0:
        raise ValueError(f"device count {n} not divisible by fsdp={fsdp}")


def create_mesh(num_devices: Optional[int] = None, fsdp: int = 1, device_type: str = "cpu"):
    """The ``(data, fsdp)`` :class:`DeviceMesh` over the process group; fsdp=1 is pure data parallel.

    ``num_devices`` must be the group's size (one process per device): the
    mesh is ``arange(W).reshape(W // fsdp, fsdp)``, so the ranks of one fsdp
    group are neighbours. Raises ``ValueError`` when ``fsdp`` does not divide
    the count, ``RuntimeError`` without a process group.
    """
    n = process_count() if num_devices is None else int(num_devices)
    _check_fsdp(n, fsdp)
    if not is_initialized():
        raise RuntimeError("create_mesh needs a process group (maybe_initialize_distributed)")
    if n != process_count():
        raise ValueError(f"a mesh of {n} devices over {process_count()} processes: the port runs one process a device")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n // fsdp, fsdp), mesh_dim_names=MESH_DIMS)


def fsdp_axis(shape: tuple, fsdp_size: int, min_size: int) -> Optional[int]:
    """The dim sharded over ``fsdp`` (JAX ``mesh._fsdp_spec``): the largest
    one, if it is at least ``min_size`` and divisible by ``fsdp_size``
    (the first of equal largest dims); None replicates."""
    shape = tuple(shape)
    if fsdp_size <= 1 or not shape or max(shape) < min_size:
        return None
    axis = max(range(len(shape)), key=lambda i: (shape[i], -i))
    return axis if shape[axis] % fsdp_size == 0 else None


def fsdp_placements(shape: tuple, fsdp_size: int, min_size: int) -> tuple:
    """``(Replicate(), Shard(axis) | Replicate())`` over ``(data, fsdp)``."""
    axis = fsdp_axis(shape, fsdp_size, min_size)
    return (Replicate(), Replicate() if axis is None else Shard(axis))


def param_shardings(mesh, params: Iterable[tuple[str, torch.Tensor]], min_size: int = 1024) -> dict:
    """{name: placements} for named tensors (``module.named_parameters()``)."""
    size = mesh.size(MESH_DIMS.index("fsdp"))
    return {name: fsdp_placements(tuple(t.shape), size, min_size) for name, t in params}


def batch_sharding(mesh) -> tuple:
    """The batch dim split over both mesh dims."""
    return (Shard(0), Shard(0))


def replicated_sharding(mesh) -> tuple:
    return (Replicate(), Replicate())


def chunk_sharding(mesh) -> tuple:
    """A ``(steps, batch, ...)`` stack: the steps dim whole, the batch dim split."""
    return (Shard(1), Shard(1))


def _rows(x: Any, dim: int, index: int, count: int) -> Any:
    if count == 1 or not (torch.is_tensor(x) or hasattr(x, "shape")):
        return x
    sl = [slice(None)] * dim + [slice(index, None, count)]
    return x[tuple(sl)]


def shard_batch(mesh, batch: Any, index: Optional[int] = None, count: Optional[int] = None) -> Any:
    """This rank's rows ``index::count`` of a global batch (a tensor, an
    array or a tuple of them); the rank and world size by default."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if isinstance(batch, (tuple, list)):
        return type(batch)(_rows(x, 0, index, count) for x in batch)
    return _rows(batch, 0, index, count)


def shard_chunk(mesh, chunk: Any, index: Optional[int] = None, count: Optional[int] = None) -> Any:
    """:func:`shard_batch` along dim 1 of ``(steps, batch, ...)`` stacks."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if isinstance(chunk, (tuple, list)):
        return type(chunk)(_rows(x, 1, index, count) for x in chunk)
    return _rows(chunk, 1, index, count)


class ShardedGenerator(torch.Generator):
    """A ``torch.Generator`` that knows this rank's rows of the global batch:
    ``rows = (index, count)``. Per-example draws from it (:func:`draw_rows`)
    are made for all ``count`` ranks' examples and sliced, so every rank
    advances it alike; ``(0, 1)`` is one process."""

    rows: tuple = (0, 1)


def sharded_generator(seed: int, rows: tuple = (0, 1)) -> torch.Generator:
    gen = ShardedGenerator(device="cpu")
    gen.manual_seed(seed)
    gen.rows = (int(rows[0]), int(rows[1]))
    return gen


def generator_rows(generator: Optional[torch.Generator]) -> tuple:
    """``(index, count)`` of a :class:`ShardedGenerator`, ``(0, 1)`` for any other."""
    return getattr(generator, "rows", (0, 1))


def draw_rows(draw: Callable[[int], torch.Tensor], batch: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``draw(n)`` makes n per-example draws along dim 0; returns this rank's
    ``batch`` of them: all ``batch × count`` drawn, rows ``index::count`` kept."""
    index, count = generator_rows(generator)
    if count == 1:
        return draw(batch)
    return draw(batch * count)[index::count]


_batch_group = None  # the process group whose ranks hold the rows of the batch being computed


@contextlib.contextmanager
def sharded_batch(group) -> Iterator[None]:
    """Within it, :func:`batch_sum` sums over ``group``'s ranks (None: one process)."""
    global _batch_group
    previous, _batch_group = _batch_group, group
    try:
        yield
    finally:
        _batch_group = previous


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, a sum over this rank's rows, summed over every rank's rows inside
    :func:`sharded_batch` (an autograd-aware ``all_reduce``: the backward sums
    the ranks' gradients), else ``x`` itself."""
    if _batch_group is None:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=_batch_group)


def batch_sharded() -> bool:
    """Whether the batch being computed is split over several ranks."""
    return _batch_group is not None


__all__ = [
    "MESH_DIMS",
    "sharded_batch",
    "batch_sum",
    "batch_sharded",
    "create_mesh",
    "fsdp_axis",
    "fsdp_placements",
    "param_shardings",
    "batch_sharding",
    "replicated_sharding",
    "chunk_sharding",
    "shard_batch",
    "shard_chunk",
    "ShardedGenerator",
    "sharded_generator",
    "generator_rows",
    "draw_rows",
]

"""Process-group start-up and host-side barriers (counterpart of
``stain2stain_tpu/parallel/distributed.py``).

One process per device. :func:`maybe_initialize_distributed` joins the
process group when the launch variables say so, and is a no-op without them:

- torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` (and
  ``LOCAL_RANK``, the card of this process);
- the JAX package's ``COORDINATOR_ADDRESS`` (``host:port``),
  ``NUM_PROCESSES`` and ``PROCESS_ID``, so one launch line serves both
  packages.

The group's backend is NCCL for CUDA tensors and gloo for CPU tensors
(``"cpu:gloo,cuda:nccl"``), gloo alone where this torch has no NCCL or no
card. A group that already exists (a caller that ran
``init_process_group`` itself) is used as it is.

A failed start raises. The JAX package logs it and carries on in one
process (``distributed.py:57-59``); here that would train W independent
copies of the model and write W sets of checkpoints, so it is an error.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=False)

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_JAX = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if is_initialized() else 1


def launch_rank() -> int:
    """The rank the launch variables give this process, before the group is
    up (0 without them): files that only rank 0 writes are gated on it."""
    if is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK") or os.environ.get("PROCESS_ID") or 0)


def local_rank() -> int:
    """The card of this process: ``LOCAL_RANK``, else its rank modulo the cards visible."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return process_index() % max(1, torch.cuda.device_count())


def launch_config() -> Optional[tuple[int, int, str]]:
    """(rank, world size, init method) from the launch variables, or None."""
    if all(os.environ.get(k) for k in _TORCHRUN):
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    if all(os.environ.get(k) for k in _JAX):
        return int(os.environ["PROCESS_ID"]), int(os.environ["NUM_PROCESSES"]), f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    return None


def default_backend() -> str:
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def maybe_initialize_distributed() -> bool:
    """Join the process group when launched for it; True if one is up."""
    if is_initialized():
        return True
    launch = launch_config()
    if launch is None:
        return False
    rank, world, init_method = launch
    dist.init_process_group(default_backend(), init_method=init_method, rank=rank, world_size=world)
    if torch.cuda.is_available() and local_rank() < torch.cuda.device_count():
        torch.cuda.set_device(local_rank())  # NCCL's collectives run on this process's card
    log.info(f"Process group up: rank {rank} of {world}, backend {dist.get_backend()}")
    return True


_host_group = None


def _gloo_group():
    """A gloo group over every rank, made once (collective: at the first call)."""
    global _host_group
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank, over gloo (host memory); ``obj`` as is in one process."""
    if process_count() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_gloo_group())
    return box[0]


def host_barrier(name: str, timeout_s: int = 900) -> None:
    """Every process waits here until all have arrived (no-op in one process).

    A ``monitored_barrier`` on a gloo group of its own, not a device
    collective: rank-0-only work (data generation, ``prepare_data``) may take
    minutes, and a collective on the card would tie the barrier to NCCL's
    timeouts and streams (the JAX package's reason, ``distributed.py:65-77``).
    On a timeout it names the ranks that did not arrive. Every process must
    pass the same barriers in the same order: the gloo group is made at the
    first one.
    """
    if process_count() <= 1:
        return
    log.debug(f"host barrier {name}")
    dist.monitored_barrier(group=_gloo_group(), timeout=datetime.timedelta(seconds=timeout_s))


__all__ = [
    "maybe_initialize_distributed",
    "host_barrier",
    "broadcast_object",
    "is_initialized",
    "process_index",
    "process_count",
    "launch_rank",
    "local_rank",
    "launch_config",
    "default_backend",
]

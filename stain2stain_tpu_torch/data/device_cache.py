"""CUDA-resident dataset cache: decode once, gather batches on the card
(counterpart of ``stain2stain_tpu/data/device_cache.py``).

On its first iteration :class:`DeviceCacheLoader` decodes the whole dataset
through the normal pipeline, keeps every array field on the CUDA card, and
from then on gathers each batch by index there: no host→device image
traffic per step. Epoch order and shuffling are :class:`DataLoader`'s, so
the cached and streaming loaders yield the same example stream. Non-array
fields (filenames) stay on the host. With more than one process the
loader streams instead (JAX ``device_cache.py:84-89``: each process
would cache the whole dataset for its slice of every batch), and says so.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device
from ..utils.pylogger import RankedLogger
from .base import DataLoader

log = RankedLogger(__name__, rank_zero_only=True)

_MAX_CACHE_BYTES_DEFAULT = 8 << 30


class DeviceCacheLoader(DataLoader):
    """Drop-in :class:`DataLoader` whose batches are gathers on the CUDA card."""

    def __init__(self, *args, max_cache_bytes: int = _MAX_CACHE_BYTES_DEFAULT, **kw):
        super().__init__(*args, **kw)
        self.max_cache_bytes = max_cache_bytes
        self._fields = None  # per field: a device tensor, or a host list
        if self.num_shards > 1:
            log.info(f"cache='device' over {self.num_shards} processes: each streams its slice instead")

    def _materialize(self) -> None:
        full = self._fetch(np.arange(len(self.dataset)))
        total = sum(f.nbytes for f in full if isinstance(f, np.ndarray))
        if total > self.max_cache_bytes:
            raise ValueError(
                f"device cache would need {total / 2**30:.2f} GiB (max_cache_bytes="
                f"{self.max_cache_bytes / 2**30:.2f} GiB); use the streaming DataLoader"
            )
        device = resolve_device(None)
        self._fields = [
            torch.from_numpy(np.ascontiguousarray(f)).to(device) if isinstance(f, np.ndarray) else f for f in full
        ]

    def __iter__(self) -> Iterator[tuple]:
        if self.num_shards > 1:
            yield from super().__iter__()
            return
        if self._fields is None:
            self._materialize()
        for idxs in self._local_batches():
            out = []
            for field in self._fields:
                if torch.is_tensor(field):
                    out.append(field.index_select(0, torch.from_numpy(idxs).to(field.device)))
                else:
                    out.append([field[int(i)] for i in idxs])
            yield tuple(out)


def resolve_loader_class(cache):
    """Map a datamodule ``cache`` config value to a loader class."""
    if cache in (None, "none"):
        return DataLoader
    if cache == "device":
        return DeviceCacheLoader
    raise ValueError(f"cache must be None or 'device', got {cache!r}")


__all__ = ["DeviceCacheLoader", "resolve_loader_class"]

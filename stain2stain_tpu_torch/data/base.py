"""Data pipeline base: datasets, threaded prefetching loader, DataModule
(counterpart of ``stain2stain_tpu/data/base.py``, for one process).

- The host only decodes: datasets return uint8 numpy arrays; normalization
  and the paired augmentation run on the device in the task's
  ``prepare_batch``.
- A thread pool with a bounded prefetch queue stands in for torch's worker
  processes (image decode releases the interpreter lock); ``num_workers``
  is the thread count and ``prefetch_factor`` batches stay in flight.
- Epoch ``e`` shuffles with the permutation seed ``seed + e``
  (:meth:`DataLoader.set_epoch`), so a resumed run sees the same order.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


class Dataset:
    """Minimal map-style dataset protocol."""

    def __len__(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def __getitem__(self, idx: int) -> tuple:  # pragma: no cover - interface
        raise NotImplementedError


def default_collate(samples: list[tuple]) -> tuple:
    """Stack a list of per-example tuples into a tuple of batched arrays."""
    out = []
    for i, field in enumerate(samples[0]):
        vals = [s[i] for s in samples]
        if isinstance(field, np.ndarray):
            out.append(np.ascontiguousarray(np.stack(vals)))
        elif isinstance(field, (int, np.integer)):
            out.append(np.asarray(vals, dtype=np.int32))
        elif isinstance(field, (float, np.floating)):
            out.append(np.asarray(vals, dtype=np.float32))
        else:
            out.append(vals)  # strings (filenames) stay a list
    return tuple(out)


class DataLoader:
    """Threaded, prefetching, optionally shuffled batch loader."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch_factor: int = 2,
        seed: int = 0,
        collate_fn: Callable = default_collate,
    ):
        if drop_last and 0 < len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} examples but the batch size is {batch_size} "
                "with drop_last=True - no full batch can ever be formed"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.seed = seed
        self.collate_fn = collate_fn
        self._epoch = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> list[np.ndarray]:
        """Index arrays of this epoch's batches (shared with the device cache)."""
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self._epoch).permutation(n)
        else:
            indices = np.arange(n)
        return [indices[b * self.batch_size : (b + 1) * self.batch_size] for b in range(len(self))]

    def _fetch(self, idxs: np.ndarray) -> tuple:
        get_batch = getattr(self.dataset, "get_batch", None)
        # native fast path: one call decodes the whole batch (None when unavailable)
        batch = get_batch(idxs) if get_batch is not None else None
        if batch is not None:
            return batch
        if self.num_workers > 1 and len(idxs) > 1:
            with self._pool_lock:  # two iterators may race to create the pool
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            samples = list(self._pool.map(lambda i: self.dataset[int(i)], idxs))
        else:
            samples = [self.dataset[int(i)] for i in idxs]
        return self.collate_fn(samples)

    def __iter__(self) -> Iterator[tuple]:
        batches = self._batches()
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_factor)
        stop = threading.Event()

        def bounded_put(item) -> bool:
            # a consumer that leaves the epoch early never drains the queue
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idxs in batches:
                    if stop.is_set() or not bounded_put(self._fetch(idxs)):
                        return
                bounded_put(None)
            except BaseException as e:  # surface worker errors to the consumer
                bounded_put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            producer.join(timeout=30)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)


class DataModule:
    """Lightning-DataModule-shaped base: prepare / setup / loaders."""

    def prepare_data(self) -> None:
        pass

    def setup(self, stage: Optional[str] = None) -> None:
        pass

    def train_dataloader(self) -> Optional[DataLoader]:
        return None

    def val_dataloader(self) -> Optional[DataLoader]:
        return None

    def test_dataloader(self) -> Optional[DataLoader]:
        return None


__all__ = ["Dataset", "DataLoader", "DataModule", "default_collate"]

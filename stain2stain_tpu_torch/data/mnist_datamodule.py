"""MNIST datamodule of the template demo (counterpart of
``stain2stain_tpu/data/mnist_datamodule.py``).

55k/5k/10k train/val/test split of the 70k MNIST digits when torchvision's
MNIST lies under ``data_dir`` (nothing is downloaded). Otherwise a
deterministic synthetic digit set, :func:`_synthetic_mnist` (numpy: the same
digits as the JAX package's for the same seed), split in the same
proportions. Batches are (uint8 (B, 28, 28) images, int labels): the fields
``("raw", "label")``, normalized by the task. ``batch_size`` is the global
batch: each process loads its slice (``num_shards``, ``shard_index`` from the
process group).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..parallel.distributed import process_count, process_index
from .base import DataLoader, DataModule, Dataset


class ArrayDataset(Dataset):
    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images = images
        self.labels = labels

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> tuple:
        return self.images[idx], int(self.labels[idx])


def _synthetic_mnist(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable 28×28 uint8 digits: class-keyed blob
    patterns + noise — enough signal for the classifier smoke tests."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    yy, xx = np.mgrid[0:28, 0:28]
    images = np.empty((n, 28, 28), np.uint8)
    for c in range(10):
        cx, cy = 6 + (c % 5) * 4, 6 + (c // 5) * 12
        pattern = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 30.0))
        sel = labels == c
        noise = rng.random((int(sel.sum()), 28, 28)) * 0.3
        images[sel] = ((pattern[None] * 0.7 + noise) * 255).astype(np.uint8)
    return images, labels.astype(np.int64)


class MNISTDataModule(DataModule):
    field_kinds = ("raw", "label")

    def __init__(
        self,
        data_dir: str = "data/",
        batch_size: int = 64,
        train_val_test_split: tuple = (55_000, 5_000, 10_000),
        num_workers: int = 0,
        pin_memory: bool = False,
        seed: int = 0,
        synthetic_size: int = 4_000,
    ):
        self.data_dir = data_dir
        self.batch_size = batch_size
        self.split = tuple(train_val_test_split)
        self.num_workers = num_workers
        self.seed = seed
        self.synthetic_size = synthetic_size
        self.num_shards = process_count()
        self.shard_index = process_index()
        self.data_train = self.data_val = self.data_test = None

    def _load_real(self) -> Optional[tuple]:
        """torchvision's MNIST under ``data_dir`` (train and test, 70k), or None."""
        try:
            from torchvision.datasets import MNIST

            train = MNIST(self.data_dir, train=True, download=False)
            test = MNIST(self.data_dir, train=False, download=False)
            return (
                np.concatenate([train.data.numpy(), test.data.numpy()]),
                np.concatenate([train.targets.numpy(), test.targets.numpy()]),
            )
        except Exception:  # no torchvision, or no MNIST on disk: the synthetic digits
            return None

    def setup(self, stage: Optional[str] = None) -> None:
        if self.data_train is not None:
            return
        real = self._load_real()
        if real is not None:
            images, labels = real
            n_train, n_val, n_test = self.split
        else:
            images, labels = _synthetic_mnist(self.synthetic_size, self.seed)
            # scale the 55k/5k/10k proportions down to the synthetic size
            total = sum(self.split)
            n_train = int(len(images) * self.split[0] / total)
            n_val = int(len(images) * self.split[1] / total)
            n_test = len(images) - n_train - n_val
        perm = np.random.default_rng(self.seed).permutation(len(images))
        images, labels = images[perm], labels[perm]
        self.data_train = ArrayDataset(images[:n_train], labels[:n_train])
        self.data_val = ArrayDataset(images[n_train : n_train + n_val], labels[n_train : n_train + n_val])
        self.data_test = ArrayDataset(images[n_train + n_val :], labels[n_train + n_val :])

    def _loader(self, ds, shuffle: bool):
        if ds is None or len(ds) == 0:
            return None
        return DataLoader(ds, batch_size=self.batch_size, shuffle=shuffle, drop_last=shuffle,
                          num_workers=max(1, self.num_workers), seed=self.seed,
                          shard_index=self.shard_index, num_shards=self.num_shards)

    def train_dataloader(self):
        return self._loader(self.data_train, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.data_val, shuffle=False)

    def test_dataloader(self):
        return self._loader(self.data_test, shuffle=False)


__all__ = ["MNISTDataModule", "ArrayDataset"]

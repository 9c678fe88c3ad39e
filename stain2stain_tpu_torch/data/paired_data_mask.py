"""Paired H&E↔IHC tiles with a binary amyloid mask, CSV-metadata driven
(counterpart of ``stain2stain_tpu/data/paired_data_mask.py``).

Each example is ``(he, ihc, mask)``: uint8 RGB tiles resized to
``image_size`` and the mask read grayscale, resized nearest and binarized
``> 1 → 1`` (uint8 (H, W, 1)). The mask file is the ``mask_column``
(``amyloid_filepath``). ``direction`` ``HE_to_IHC`` keeps (he, ihc); any
other value swaps them. The reference pipeline resizes only: no crop, no
flip (``train_augment`` is None).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..parallel.distributed import process_count, process_index
from .base import DataLoader, DataModule, Dataset
from .paired_data_module import _read_split, load_rgb, resize_uint8


def load_mask_binary(path: str, size: int) -> np.ndarray:
    """Grayscale → nearest resize → binarize (> 1 → 1): uint8 (H, W)."""
    import cv2

    mask = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if mask is None:
        from PIL import Image

        mask = np.asarray(Image.open(path).convert("L"), dtype=np.uint8)
    mask = cv2.resize(mask, (size, size), interpolation=cv2.INTER_NEAREST)
    return np.where(mask > 1, 1, 0).astype(np.uint8)


class PairedHEIHCDataset(Dataset):
    def __init__(
        self,
        data_dir: str,
        csv_file_name: str,
        source_column: str,
        target_column: str,
        folder: str,
        mask_column: str = "amyloid_filepath",
        image_size: int = 512,
        direction: str = "HE_to_IHC",
    ):
        self.tile_dir = os.path.join(data_dir, folder)
        self.image_size = image_size
        self.swap = direction != "HE_to_IHC"
        csv_path = os.path.join(data_dir, csv_file_name)
        if not os.path.exists(csv_path):
            raise FileNotFoundError(f"Metadata CSV not found: {csv_path}")
        rows = _read_split(csv_path, folder)
        self.source_files = [r[source_column] for r in rows]
        self.target_files = [r[target_column] for r in rows]
        self.mask_files = [r[mask_column] for r in rows]

    def __len__(self) -> int:
        return len(self.source_files)

    def __getitem__(self, idx: int) -> tuple:
        he = resize_uint8(load_rgb(os.path.join(self.tile_dir, self.source_files[idx])), self.image_size)
        ihc = resize_uint8(load_rgb(os.path.join(self.tile_dir, self.target_files[idx])), self.image_size)
        mask = load_mask_binary(os.path.join(self.tile_dir, self.mask_files[idx]), self.image_size)[..., None]
        if self.swap:
            he, ihc = ihc, he
        return he, ihc, mask

    def get_batch(self, indices) -> tuple | None:
        """The whole batch in two native decode calls (both RGB columns, then
        the masks nearest), or None without the library."""
        from . import native

        if not native.available():
            return None
        size, n = self.image_size, len(indices)
        paths = [os.path.join(self.tile_dir, self.source_files[int(i)]) for i in indices]
        paths += [os.path.join(self.tile_dir, self.target_files[int(i)]) for i in indices]
        both = native.decode_batch(paths, size=size)
        he, ihc = both[:n], both[n:]
        mask_paths = [os.path.join(self.tile_dir, self.mask_files[int(i)]) for i in indices]
        masks = native.decode_batch(mask_paths, size=size, channels=1, nearest=True)
        masks = np.where(masks > 1, 1, 0).astype(np.uint8)
        if self.swap:
            he, ihc = ihc, he
        return he, ihc, masks


class PairedHEIHCDataModule(DataModule):
    """Config surface of ``configs/data/paired_data_mask_he_amyloid.yaml``."""

    field_kinds = ("image", "image", "mask")
    train_augment = None  # the reference pipeline resizes only

    def __init__(
        self,
        data_dir: str = "data/",
        csv_file_name: str = "metadata.csv",
        source_column: str = "he_filepath",
        target_column: str = "ihc_filepath",
        mask_column: str = "amyloid_filepath",
        batch_size: int = 8,
        num_workers: int = 4,
        image_size: int = 512,
        direction: str = "HE_to_IHC",
        pin_memory: bool = True,  # config parity: host batches are copied by the task
        seed: int = 0,
        prefetch_factor: int = 2,
        cache: Optional[str] = None,
    ):
        from .device_cache import resolve_loader_class

        self.data_dir = data_dir
        self.csv_file_name = csv_file_name
        self.source_column = source_column
        self.target_column = target_column
        self.mask_column = mask_column
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.image_size = image_size
        self.direction = direction
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self._loader_cls = resolve_loader_class(cache)
        self.num_shards = process_count()
        self.shard_index = process_index()
        self.datasets: dict[str, PairedHEIHCDataset] = {}

    def setup(self, stage: Optional[str] = None) -> None:
        for folder in ("train", "val", "test"):
            if folder in self.datasets:
                continue
            try:
                self.datasets[folder] = PairedHEIHCDataset(
                    data_dir=self.data_dir,
                    csv_file_name=self.csv_file_name,
                    source_column=self.source_column,
                    target_column=self.target_column,
                    mask_column=self.mask_column,
                    folder=folder,
                    image_size=self.image_size,
                    direction=self.direction,
                )
            except FileNotFoundError:
                if folder == "train":
                    raise

    def _loader(self, folder: str, shuffle: bool) -> Optional[DataLoader]:
        ds = self.datasets.get(folder)
        if ds is None or len(ds) == 0:
            return None
        return self._loader_cls(
            ds,
            batch_size=self.batch_size,
            shuffle=shuffle,
            drop_last=shuffle,
            num_workers=self.num_workers,
            prefetch_factor=self.prefetch_factor,
            seed=self.seed,
            shard_index=self.shard_index,
            num_shards=self.num_shards,
        )

    def train_dataloader(self) -> Optional[DataLoader]:
        return self._loader("train", shuffle=True)

    def val_dataloader(self) -> Optional[DataLoader]:
        return self._loader("val", shuffle=False)

    def test_dataloader(self) -> Optional[DataLoader]:
        return self._loader("test", shuffle=False)


__all__ = ["PairedHEIHCDataset", "PairedHEIHCDataModule", "load_mask_binary"]

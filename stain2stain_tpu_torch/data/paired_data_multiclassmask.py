"""Paired tiles with an integer multiclass segmentation mask, CSV-metadata
driven (counterpart of ``stain2stain_tpu/data/paired_data_multiclassmask.py``).

Each example is ``(src, tgt, class_mask)``: uint8 RGB tiles and the mask's
class ids read grayscale, resized nearest only when the size differs (cv2,
PIL when cv2 cannot read the file) and kept as int32 (H, W): never
normalized, never through floats, in the per-tile path, the native batch
path (``get_batch``), the collate and ``cache: device`` alike. The mask file
is the ``mask_column`` (``graywhite_filepath``). The direction swap follows
``resolve_direction_swap`` (``direction_compat``). With
``use_augmentation`` the training tiles are decoded at ``load_size`` and
the task crops and flips them with the mask on the device; the test loader
(and the val loader) never augment.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..parallel.distributed import process_count, process_index
from .base import DataLoader, DataModule, Dataset
from .paired_data_module import _read_split, load_rgb, resize_uint8, resolve_direction_swap


def load_class_mask(path: str, size: int) -> np.ndarray:
    """Grayscale class ids, nearest-resized to ``size`` if needed: int32 (H, W)."""
    import cv2

    mask = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if mask is None:
        from PIL import Image

        mask = np.asarray(Image.open(path).convert("L"), dtype=np.uint8)
    if mask.shape[0] != size or mask.shape[1] != size:
        mask = cv2.resize(mask, (size, size), interpolation=cv2.INTER_NEAREST)
    return mask.astype(np.int32)


class PairedMulticlassDataset(Dataset):
    def __init__(
        self,
        data_dir: str,
        csv_file_name: str,
        source_column: str,
        target_column: str,
        folder: str,
        mask_column: str = "graywhite_filepath",
        image_size: int = 512,
        direction: str = "S2T",
        use_augmentation: bool = False,
        load_size: Optional[int] = None,
        direction_compat: str = "reference",
    ):
        self.tile_dir = os.path.join(data_dir, folder)
        self.image_size = image_size
        self.use_augmentation = use_augmentation
        self.load_size = load_size if load_size is not None else image_size
        self.swap = resolve_direction_swap(direction, direction_compat)
        csv_path = os.path.join(data_dir, csv_file_name)
        if not os.path.exists(csv_path):
            raise FileNotFoundError(f"Metadata CSV not found: {csv_path}")
        rows = _read_split(csv_path, folder)
        self.source_files = [r[source_column] for r in rows]
        self.target_files = [r[target_column] for r in rows]
        self.mask_files = [r[mask_column] for r in rows]

    def __len__(self) -> int:
        return len(self.source_files)

    @property
    def _size(self) -> int:
        return self.load_size if self.use_augmentation else self.image_size

    def __getitem__(self, idx: int) -> tuple:
        size = self._size
        src = resize_uint8(load_rgb(os.path.join(self.tile_dir, self.source_files[idx])), size)
        tgt = resize_uint8(load_rgb(os.path.join(self.tile_dir, self.target_files[idx])), size)
        mask = load_class_mask(os.path.join(self.tile_dir, self.mask_files[idx]), size)
        if self.swap:
            src, tgt = tgt, src
        return src, tgt, mask

    def get_batch(self, indices) -> tuple | None:
        """The whole batch in two native decode calls (both RGB columns, then
        the masks nearest), or None without the library."""
        from . import native

        if not native.available():
            return None
        size, n = self._size, len(indices)
        paths = [os.path.join(self.tile_dir, self.source_files[int(i)]) for i in indices]
        paths += [os.path.join(self.tile_dir, self.target_files[int(i)]) for i in indices]
        both = native.decode_batch(paths, size=size)
        src, tgt = both[:n], both[n:]
        mask_paths = [os.path.join(self.tile_dir, self.mask_files[int(i)]) for i in indices]
        masks = native.decode_batch(mask_paths, size=size, channels=1, nearest=True)[..., 0].astype(np.int32)
        if self.swap:
            src, tgt = tgt, src
        return src, tgt, masks


class PairedMulticlassDataModule(DataModule):
    """Config surface of ``configs/data/paired_data_multiclass_seg_mask.yaml``."""

    field_kinds = ("image", "image", "class_mask")

    def __init__(
        self,
        data_dir: str = "data/",
        csv_file_name: str = "metadata.csv",
        source_column: str = "he_filepath",
        target_column: str = "lfb_filepath",
        mask_column: str = "graywhite_filepath",
        batch_size: int = 8,
        num_workers: int = 4,
        image_size: int = 512,
        direction: str = "S2T",
        use_augmentation: bool = False,
        load_size: Optional[int] = None,
        pin_memory: bool = True,  # config parity: host batches are copied by the task
        seed: int = 0,
        prefetch_factor: int = 2,
        direction_compat: str = "reference",
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
        self.use_augmentation = use_augmentation
        self.load_size = load_size
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self.direction_compat = direction_compat
        self._loader_cls = resolve_loader_class(cache)
        self.num_shards = process_count()
        self.shard_index = process_index()
        self.datasets: dict[str, PairedMulticlassDataset] = {}

    @property
    def train_augment(self) -> Optional[dict]:
        if not self.use_augmentation:
            return None
        return {"crop_size": self.image_size, "hflip": True, "vflip": True}

    def setup(self, stage: Optional[str] = None) -> None:
        for folder in ("train", "val", "test"):
            if folder in self.datasets:
                continue
            try:
                self.datasets[folder] = PairedMulticlassDataset(
                    data_dir=self.data_dir,
                    csv_file_name=self.csv_file_name,
                    source_column=self.source_column,
                    target_column=self.target_column,
                    mask_column=self.mask_column,
                    folder=folder,
                    image_size=self.image_size,
                    direction=self.direction,
                    direction_compat=self.direction_compat,
                    use_augmentation=self.use_augmentation and folder == "train",
                    load_size=self.load_size,
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


__all__ = ["PairedMulticlassDataset", "PairedMulticlassDataModule", "load_class_mask"]

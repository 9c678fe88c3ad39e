"""Paired source→target tile dataset and datamodule, CSV-metadata driven
(counterpart of ``stain2stain_tpu/data/paired_data_module.py``).

- The CSV's ``split`` column selects the rows of a folder; tiles live in
  ``data_dir/<split>/<filename>`` under ``source_column`` / ``target_column``.
- The host only decodes (RGB uint8) and statically resizes; normalization
  and the paired crop/flip run on the device in the task's ``prepare_batch``.
- ``cache="device"`` keeps the decoded dataset on the CUDA card
  (:mod:`.device_cache`).

Direction semantics (``direction_compat``) are the JAX package's:
``"reference"`` swaps source and target for ANY value other than ``"S2T"``
(with a warning when the value is not an explicit reverse keyword);
``"explicit"`` swaps only for ``T2S`` / ``IHC_to_HE`` / ``reverse``.
"""

from __future__ import annotations

import csv
import os
import warnings
from typing import Optional

import numpy as np

from .base import DataLoader, DataModule, Dataset

_REVERSE_DIRECTIONS = ("T2S", "IHC_to_HE", "reverse")


def resolve_direction_swap(direction: str, compat: str = "reference", forward: str = "S2T") -> bool:
    """Whether (source, target) should be swapped for ``direction``."""
    if compat not in ("reference", "explicit"):
        raise ValueError(f"direction_compat must be 'reference' or 'explicit', got {compat!r}")
    explicit_swap = direction in _REVERSE_DIRECTIONS
    if compat == "explicit":
        if direction != forward and not explicit_swap:
            warnings.warn(
                f"direction={direction!r} with direction_compat='explicit' is treated as FORWARD "
                f"(source→target); direction_compat='reference' swaps the pair for ANY value "
                f"other than {forward!r}.",
                stacklevel=3,
            )
        return explicit_swap
    swap = direction != forward
    if swap and not explicit_swap:
        warnings.warn(
            f"direction={direction!r}: reference-compat semantics swap source/target for ANY value "
            f"other than {forward!r}, so this trains the REVERSE translation (target→source). Use "
            f"direction={forward!r} for forward, or direction_compat='explicit' to treat only "
            f"{_REVERSE_DIRECTIONS} as reverse.",
            stacklevel=3,
        )
    return swap


def load_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 (H, W, 3)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def resize_uint8(img: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    import cv2

    if img.shape[0] == size and img.shape[1] == size:
        return img
    interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    return cv2.resize(img, (size, size), interpolation=interp)


def _read_split(csv_path: str, folder: str) -> list[dict]:
    with open(csv_path, newline="") as f:
        return [row for row in csv.DictReader(f) if row.get("split") == folder]


class PairedDataset(Dataset):
    """Returns (source_uint8, target_uint8[, src_name, tgt_name]) HWC tiles.

    With ``use_augmentation`` the tiles are loaded at ``load_size`` (the crop
    to ``image_size`` happens on the device); otherwise they are resized
    straight to ``image_size``.
    """

    def __init__(
        self,
        data_dir: str,
        csv_file_name: str,
        source_column: str,
        target_column: str,
        folder: str,
        image_size: int = 512,
        direction: str = "S2T",
        use_augmentation: bool = False,
        return_filename: bool = False,
        load_size: Optional[int] = None,
        direction_compat: str = "reference",
    ):
        self.tile_dir = os.path.join(data_dir, folder)
        self.image_size = image_size
        self.use_augmentation = use_augmentation
        self.return_filename = return_filename
        self.load_size = load_size if load_size is not None else image_size
        self.swap = resolve_direction_swap(direction, direction_compat)
        csv_path = os.path.join(data_dir, csv_file_name)
        if not os.path.exists(csv_path):
            raise FileNotFoundError(f"Metadata CSV not found: {csv_path}")
        rows = _read_split(csv_path, folder)
        self.source_files = [r[source_column] for r in rows]
        self.target_files = [r[target_column] for r in rows]

    def __len__(self) -> int:
        return len(self.source_files)

    @property
    def _size(self) -> int:
        return self.load_size if self.use_augmentation else self.image_size

    def _names(self, indices) -> tuple[list, list]:
        src = [self.source_files[int(i)] for i in indices]
        tgt = [self.target_files[int(i)] for i in indices]
        return (tgt, src) if self.swap else (src, tgt)

    def __getitem__(self, idx: int) -> tuple:
        (src_name,), (tgt_name,) = self._names([idx])
        src = resize_uint8(load_rgb(os.path.join(self.tile_dir, src_name)), self._size)
        tgt = resize_uint8(load_rgb(os.path.join(self.tile_dir, tgt_name)), self._size)
        return (src, tgt, src_name, tgt_name) if self.return_filename else (src, tgt)

    def get_batch(self, indices) -> tuple | None:
        """The whole batch in one native decode call, or None without the library."""
        from . import native

        if not native.available():
            return None
        src_names, tgt_names = self._names(indices)
        paths = [os.path.join(self.tile_dir, name) for name in src_names + tgt_names]
        both = native.decode_batch(paths, size=self._size)
        n = len(indices)
        if self.return_filename:
            return both[:n], both[n:], src_names, tgt_names
        return both[:n], both[n:]


class PairedDataModule(DataModule):
    """Config surface of ``configs/data/paired_data.yaml``."""

    def __init__(
        self,
        data_dir: str = "data/",
        csv_file_name: str = "metadata.csv",
        source_column: str = "he_filepath",
        target_column: str = "ihc_filepath",
        batch_size: int = 2,
        num_workers: int = 4,
        image_size: int = 512,
        direction: str = "S2T",
        pin_memory: bool = True,  # config parity: host batches are copied by the task
        use_augmentation: bool = False,
        load_size: Optional[int] = None,
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
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.image_size = image_size
        self.direction = direction
        self.direction_compat = direction_compat
        self.use_augmentation = use_augmentation
        self.load_size = load_size
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self._loader_cls = resolve_loader_class(cache)
        self.datasets: dict[str, PairedDataset] = {}

    @property
    def train_augment(self) -> Optional[dict]:
        """The device-side augmentation recipe the task's prepare_batch reads."""
        if not self.use_augmentation:
            return None
        return {"crop_size": self.image_size, "hflip": True, "vflip": True}

    def setup(self, stage: Optional[str] = None) -> None:
        for folder in ("train", "val", "test"):
            if folder in self.datasets:
                continue
            try:
                self.datasets[folder] = PairedDataset(
                    data_dir=self.data_dir,
                    csv_file_name=self.csv_file_name,
                    source_column=self.source_column,
                    target_column=self.target_column,
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
        )

    def train_dataloader(self) -> Optional[DataLoader]:
        return self._loader("train", shuffle=True)

    def val_dataloader(self) -> Optional[DataLoader]:
        return self._loader("val", shuffle=False)

    def test_dataloader(self) -> Optional[DataLoader]:
        return self._loader("test", shuffle=False)


__all__ = ["PairedDataset", "PairedDataModule", "load_rgb", "resize_uint8", "resolve_direction_swap"]

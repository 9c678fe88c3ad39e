"""Positive and negative paired tiles mixed with balanced oversampling
(counterpart of ``stain2stain_tpu/data/paired_pos_neg.py``).

- Positive pairs come from the CSV-metadata :class:`PairedDataset`.
- Negative pairs come from two folders; the file names both hold define the
  dataset, and each pair gets one shared random crop drawn from
  (seed, epoch, index).
- Training concatenates both and draws with replacement under 1/N class
  weights, so the smaller set is oversampled to balance (the loader's
  ``sampler_weights``). Validation and test are positive only.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..parallel.distributed import process_count, process_index
from .base import ConcatDataset, DataLoader, DataModule, Dataset
from .paired_data_module import PairedDataset, load_rgb

_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")


class NegativePairedDataset(Dataset):
    """Folder-intersection paired tiles with a shared random crop, resized to
    ``out_size`` when it differs from ``crop_size`` (so negatives collate with
    the positives' tiles)."""

    def __init__(
        self,
        he_dir: str,
        ihc_dir: str,
        crop_size: int = 256,
        direction: str = "HE_to_IHC",
        seed: int = 0,
        out_size: Optional[int] = None,
    ):
        self.he_dir = he_dir
        self.ihc_dir = ihc_dir
        self.crop_size = crop_size
        self.out_size = out_size or crop_size
        self.swap = direction != "HE_to_IHC"
        self.seed = seed
        self._epoch = 0
        he_files = {f for f in os.listdir(he_dir) if f.lower().endswith(_EXTS)}
        ihc_files = {f for f in os.listdir(ihc_dir) if f.lower().endswith(_EXTS)}
        self.image_files = sorted(he_files & ihc_files)
        if not self.image_files:
            raise ValueError(f"No shared filenames between {he_dir} and {ihc_dir}")

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.image_files)

    def __getitem__(self, idx: int) -> tuple:
        fname = self.image_files[idx]
        he = load_rgb(os.path.join(self.he_dir, fname))
        ihc = load_rgb(os.path.join(self.ihc_dir, fname))
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        h, w = he.shape[:2]
        top = int(rng.integers(0, max(h - self.crop_size, 0) + 1))
        left = int(rng.integers(0, max(w - self.crop_size, 0) + 1))
        he, ihc = self._crop(he, top, left), self._crop(ihc, top, left)
        if self.swap:
            he, ihc = ihc, he
        return he, ihc

    def _crop(self, img: np.ndarray, top: int, left: int) -> np.ndarray:
        out = img[top : top + self.crop_size, left : left + self.crop_size]
        if out.shape[0] != self.out_size or out.shape[1] != self.out_size:
            import cv2

            out = cv2.resize(out, (self.out_size, self.out_size))
        return out


class PairedPosNegDataModule(DataModule):
    """Config surface of ``configs/data/paired_pos_neg_he_amyloid.yaml``."""

    field_kinds = ("image", "image")
    train_augment = None  # negatives are cropped on the host, per item

    def __init__(
        self,
        data_dir: str = "data/",
        csv_file_name: str = "metadata.csv",
        source_column: str = "he_filepath",
        target_column: str = "ihc_filepath",
        negative_data_dir: Optional[str] = None,
        negative_he_folder: str = "train_he",
        negative_ihc_folder: str = "train_ihc",
        use_negative_data: bool = False,
        batch_size: int = 8,
        num_workers: int = 4,
        image_size: int = 256,
        crop_size: Optional[int] = None,
        direction: str = "HE_to_IHC",
        pin_memory: bool = True,  # config parity: host batches are copied by the task
        seed: int = 0,
        prefetch_factor: int = 2,
    ):
        self.data_dir = data_dir
        self.csv_file_name = csv_file_name
        self.source_column = source_column
        self.target_column = target_column
        self.negative_data_dir = negative_data_dir
        self.negative_he_folder = negative_he_folder
        self.negative_ihc_folder = negative_ihc_folder
        self.use_negative_data = use_negative_data
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.image_size = image_size
        self.crop_size = crop_size or image_size
        self.direction = direction
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self.data_train: Optional[Dataset] = None
        self.train_weights: Optional[np.ndarray] = None
        self.data_val: Optional[Dataset] = None
        self.data_test: Optional[Dataset] = None
        self.num_shards = process_count()
        self.shard_index = process_index()

    def _positive(self, folder: str) -> PairedDataset:
        return PairedDataset(
            data_dir=self.data_dir,
            csv_file_name=self.csv_file_name,
            source_column=self.source_column,
            target_column=self.target_column,
            folder=folder,
            image_size=self.image_size,
            direction="S2T" if self.direction == "HE_to_IHC" else "T2S",
        )

    def setup(self, stage: Optional[str] = None) -> None:
        if self.data_train is not None:
            return
        positive = self._positive("train")
        # both the flag and a directory, else positive-only training
        if self.use_negative_data and self.negative_data_dir is not None:
            negative = NegativePairedDataset(
                he_dir=os.path.join(self.negative_data_dir, self.negative_he_folder),
                ihc_dir=os.path.join(self.negative_data_dir, self.negative_ihc_folder),
                crop_size=self.crop_size,
                direction=self.direction,
                seed=self.seed,
                out_size=self.image_size,
            )
            self.data_train = ConcatDataset([positive, negative])
            n_pos, n_neg = len(positive), len(negative)
            self.train_weights = np.concatenate([np.full(n_pos, 1.0 / n_pos), np.full(n_neg, 1.0 / n_neg)])
        else:
            self.data_train = positive
            self.train_weights = None
        for folder in ("val", "test"):
            try:
                ds = self._positive(folder)
                setattr(self, f"data_{folder}", ds if len(ds) else None)
            except FileNotFoundError:
                pass

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.data_train,
            batch_size=self.batch_size,
            shuffle=True,
            drop_last=True,
            num_workers=self.num_workers,
            prefetch_factor=self.prefetch_factor,
            seed=self.seed,
            sampler_weights=self.train_weights,
            shard_index=self.shard_index,
            num_shards=self.num_shards,
        )

    def _eval_loader(self, ds) -> Optional[DataLoader]:
        if ds is None:
            return None
        return DataLoader(ds, batch_size=self.batch_size, shuffle=False, num_workers=self.num_workers, seed=self.seed,
                          shard_index=self.shard_index, num_shards=self.num_shards)

    def val_dataloader(self) -> Optional[DataLoader]:
        return self._eval_loader(self.data_val)

    def test_dataloader(self) -> Optional[DataLoader]:
        return self._eval_loader(self.data_test)


__all__ = ["NegativePairedDataset", "PairedPosNegDataModule"]

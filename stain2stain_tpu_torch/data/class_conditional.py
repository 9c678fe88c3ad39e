"""Any↔any class-conditional domain datasets, one folder per stain
(counterpart of ``stain2stain_tpu/data/class_conditional.py``).

- The domain folders share filenames; ``class_folder_mapping`` maps a class
  index to its folder (``configs/data/class_conditional_he_amyloid.yaml``).
- Each item draws a source and a target domain; in ``union`` filename mode
  the pair is drawn again until both domains hold the file.
- Source and target share one random crop (``same_crop_for_pair``).
- ``prepare_data`` writes a seeded ``train_val_split.json`` once; ``setup``
  reads it.

Each item's draws come from ``numpy.random.default_rng((seed, epoch,
index))``, as in the JAX package, so the same folders, split file and seed
give the same batches bit for bit; the loader's ``set_epoch`` moves the
dataset to the next epoch's draws.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from ..parallel.distributed import process_count, process_index
from .base import DataLoader, DataModule, Dataset
from .paired_data_module import load_rgb

_DEFAULT_MAPPING = {0: "HE", 1: "IHC", 2: "Grayscale"}
_DEFAULT_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")


class PairedAnyToAnyDataset(Dataset):
    """Returns (src_uint8, tgt_uint8, target_label) with a shared random crop."""

    def __init__(
        self,
        root_dir: str,
        class_folder_mapping: Optional[dict] = None,
        crop_size: int = 256,
        same_crop_for_pair: bool = True,
        source_domain_mode: Union[str, int] = "random",
        filename_mode: str = "intersection",
        allowed_exts: Sequence[str] = _DEFAULT_EXTS,
        valid_filenames: Optional[Sequence[str]] = None,
        seed: int = 0,
    ):
        mapping = {int(k): v for k, v in (class_folder_mapping or _DEFAULT_MAPPING).items()}
        self.class_folder_mapping = mapping
        self.crop_size = crop_size
        self.same_crop_for_pair = same_crop_for_pair
        self.source_domain_mode = source_domain_mode
        self.filename_mode = filename_mode
        self.seed = seed
        self._epoch = 0
        self.num_classes = len(mapping)
        self.class_indices = sorted(mapping)
        self.class_to_dir = {c: os.path.join(root_dir, f) for c, f in mapping.items()}

        exts = tuple(e.lower() for e in allowed_exts)
        self.class_to_filenames: dict[int, set] = {}
        for c, d in self.class_to_dir.items():
            if not os.path.isdir(d):
                raise ValueError(f"Folder not found: {d}")
            self.class_to_filenames[c] = {f for f in os.listdir(d) if f.lower().endswith(exts)}
        sets = list(self.class_to_filenames.values())
        if filename_mode == "intersection":
            names = sorted(set.intersection(*sets)) if sets else []
        elif filename_mode == "union":
            names = sorted(set.union(*sets)) if sets else []
        else:
            raise ValueError("filename_mode must be 'intersection' or 'union'")
        if valid_filenames is not None:
            valid = set(valid_filenames)
            names = [f for f in names if f in valid]
        if not names:
            raise ValueError("No filenames found (check folders / extensions).")
        self.filenames = names

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, idx: int) -> tuple:
        fname = self.filenames[idx]
        rng = np.random.default_rng((self.seed, self._epoch, idx))
        if self.source_domain_mode == "random":
            source_label = int(rng.choice(self.class_indices))
        else:
            source_label = int(self.source_domain_mode)
        target_label = int(rng.choice(self.class_indices))

        if self.filename_mode == "union":
            tries = 0
            while (fname not in self.class_to_filenames[source_label]
                   or fname not in self.class_to_filenames[target_label]):
                if self.source_domain_mode == "random":
                    source_label = int(rng.choice(self.class_indices))
                target_label = int(rng.choice(self.class_indices))
                tries += 1
                if tries > 50:
                    raise RuntimeError(f"Could not pair '{fname}' across sampled domains; use intersection mode.")

        src = load_rgb(os.path.join(self.class_to_dir[source_label], fname))
        tgt = load_rgb(os.path.join(self.class_to_dir[target_label], fname))
        src_crop = self._draw_crop(src, rng)
        tgt_crop = src_crop if self.same_crop_for_pair else self._draw_crop(tgt, rng)
        return self._apply_crop(src, src_crop), self._apply_crop(tgt, tgt_crop), np.int32(target_label)

    def _draw_crop(self, img: np.ndarray, rng: np.random.Generator) -> tuple:
        h, w = img.shape[:2]
        top = int(rng.integers(0, max(h - self.crop_size, 0) + 1))
        left = int(rng.integers(0, max(w - self.crop_size, 0) + 1))
        return top, left

    def _apply_crop(self, img: np.ndarray, crop: tuple) -> np.ndarray:
        top, left = crop
        out = img[top : top + self.crop_size, left : left + self.crop_size]
        if out.shape[0] != self.crop_size or out.shape[1] != self.crop_size:
            import cv2

            out = cv2.resize(out, (self.crop_size, self.crop_size), interpolation=cv2.INTER_LINEAR)
        return out


class ClassConditionalAnyToAnyDataModule(DataModule):
    """The config surface of ``configs/data/class_conditional_he_amyloid.yaml``.
    The crop is drawn on the host per item (shared coordinates), so the
    trainer applies no device augmentation. The test loader is the val split."""

    field_kinds = ("image", "image", "label")
    train_augment = None

    def __init__(
        self,
        data_dir: str = "data/",
        class_folder_mapping: Optional[dict] = None,
        crop_size: int = 256,
        batch_size: int = 16,
        num_workers: int = 4,
        val_split: float = 0.1,
        split_seed: int = 42,
        source_domain_mode: Union[str, int] = "random",
        filename_mode: str = "intersection",
        same_crop_for_pair: bool = True,
        pin_memory: bool = True,  # config parity: batches are numpy arrays
        seed: int = 0,
        prefetch_factor: int = 2,
    ):
        self.data_dir = data_dir
        self.class_folder_mapping = {int(k): v for k, v in (class_folder_mapping or _DEFAULT_MAPPING).items()}
        self.crop_size = crop_size
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.val_split = val_split
        self.split_seed = split_seed
        self.source_domain_mode = source_domain_mode
        self.filename_mode = filename_mode
        self.same_crop_for_pair = same_crop_for_pair
        self.seed = seed
        self.prefetch_factor = prefetch_factor
        self.split_file = Path(data_dir) / "train_val_split.json"
        self.data_train: Optional[PairedAnyToAnyDataset] = None
        self.data_val: Optional[PairedAnyToAnyDataset] = None
        self.num_shards = process_count()
        self.shard_index = process_index()

    @property
    def num_classes(self) -> int:
        return len(self.class_folder_mapping)

    def prepare_data(self) -> None:
        """Write the seeded train/val split once."""
        if self.split_file.exists():
            return
        first_class = sorted(self.class_folder_mapping)[0]
        folder_path = os.path.join(self.data_dir, self.class_folder_mapping[first_class])
        if not os.path.isdir(folder_path):
            raise ValueError(f"Folder not found: {folder_path}")
        all_files = sorted(f for f in os.listdir(folder_path) if f.lower().endswith(_DEFAULT_EXTS))
        if not all_files:
            raise ValueError(f"No files found in {folder_path}")
        random.Random(self.split_seed).shuffle(all_files)
        n_val = int(len(all_files) * self.val_split)
        split_data = {
            "train": all_files[n_val:],
            "val": all_files[:n_val],
            "split_seed": self.split_seed,
            "val_split": self.val_split,
            "total_files": len(all_files),
            "train_files": len(all_files) - n_val,
            "val_files": n_val,
        }
        self.split_file.write_text(json.dumps(split_data, indent=2))

    def setup(self, stage: Optional[str] = None) -> None:
        if not self.split_file.exists():
            raise RuntimeError(f"Split file not found: {self.split_file}. Make sure prepare_data() was called.")
        split_data = json.loads(self.split_file.read_text())

        def make(names, seed_offset):
            return PairedAnyToAnyDataset(
                root_dir=self.data_dir,
                class_folder_mapping=self.class_folder_mapping,
                crop_size=self.crop_size,
                same_crop_for_pair=self.same_crop_for_pair,
                source_domain_mode=self.source_domain_mode,
                filename_mode=self.filename_mode,
                valid_filenames=names,
                seed=self.seed + seed_offset,
            )

        if self.data_train is None:
            self.data_train = make(split_data["train"], 0)
            self.data_val = make(split_data["val"], 1) if split_data["val"] else None

    def _loader(self, ds, shuffle: bool) -> Optional[DataLoader]:
        if ds is None or len(ds) == 0:
            return None
        return DataLoader(ds, batch_size=self.batch_size, shuffle=shuffle, drop_last=shuffle,
                          num_workers=self.num_workers, prefetch_factor=self.prefetch_factor, seed=self.seed,
                          shard_index=self.shard_index, num_shards=self.num_shards)

    def train_dataloader(self) -> Optional[DataLoader]:
        return self._loader(self.data_train, shuffle=True)

    def val_dataloader(self) -> Optional[DataLoader]:
        return self._loader(self.data_val, shuffle=False)

    def test_dataloader(self) -> Optional[DataLoader]:
        return self._loader(self.data_val, shuffle=False)  # the reference tests any2any on the val split


__all__ = ["PairedAnyToAnyDataset", "ClassConditionalAnyToAnyDataModule"]

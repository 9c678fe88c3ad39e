"""Hermetic synthetic datamodule (counterpart of ``stain2stain_tpu/data/synthetic_module.py``).

On ``prepare_data`` it writes a deterministic synthetic paired-tile tree
(:mod:`.synthetic`) and then behaves like :class:`PairedDataModule`, or with
``with_mask`` like :class:`PairedHEIHCDataModule` (a binary mask) or, with
``num_mask_classes > 1``, like :class:`PairedMulticlassDataModule` (class
ids, cropped and flipped with the tiles when ``use_augmentation``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..parallel.distributed import host_barrier, process_index
from .base import DataModule
from .paired_data_mask import PairedHEIHCDataModule
from .paired_data_module import PairedDataModule
from .paired_data_multiclassmask import PairedMulticlassDataModule
from .synthetic import generate_paired_dataset


class SyntheticPairedDataModule(DataModule):
    def __init__(
        self,
        data_dir: str = "data/synthetic",
        n_train: int = 8,
        n_val: int = 4,
        n_test: int = 4,
        tile_size: int = 64,
        image_size: int = 32,
        batch_size: int = 4,
        num_workers: int = 2,
        use_augmentation: bool = True,
        with_mask: bool = False,
        num_mask_classes: int = 0,
        seed: int = 0,
        pin_memory: bool = False,
        deterministic: bool = False,
        cache: Optional[str] = None,
    ):
        # the JAX package's directory naming, so both packages share a tree
        variant = f"s{tile_size}_m{num_mask_classes if with_mask else 0}_n{n_train}-{n_val}-{n_test}_seed{seed}"
        if deterministic:
            variant += "_det"
        self.data_dir = Path(data_dir) / variant
        self.n_train, self.n_val, self.n_test = n_train, n_val, n_test
        self.tile_size = tile_size
        self.seed = seed
        self.deterministic = deterministic
        self.with_mask = with_mask
        self.num_mask_classes = num_mask_classes
        common = dict(
            data_dir=str(self.data_dir),
            csv_file_name="metadata.csv",
            source_column="he_filepath",
            target_column="ihc_filepath",
            batch_size=batch_size,
            num_workers=num_workers,
            image_size=image_size,
            seed=seed,
            cache=cache,
        )
        if with_mask and num_mask_classes > 1:
            self._inner = PairedMulticlassDataModule(
                mask_column="graywhite_filepath",
                use_augmentation=use_augmentation,
                load_size=tile_size if use_augmentation else None,
                **common,
            )
        elif with_mask:
            self._inner = PairedHEIHCDataModule(mask_column="amyloid_filepath", **common)
        else:
            self._inner = PairedDataModule(
                use_augmentation=use_augmentation,
                load_size=tile_size if use_augmentation else None,
                direction="S2T",
                **common,
            )

    @property
    def field_kinds(self) -> tuple:
        return getattr(self._inner, "field_kinds", ("image", "image"))

    @property
    def train_augment(self):
        return self._inner.train_augment

    def prepare_data(self) -> None:
        if not (self.data_dir / "metadata.csv").exists():
            generate_paired_dataset(
                self.data_dir,
                n_train=self.n_train,
                n_val=self.n_val,
                n_test=self.n_test,
                size=self.tile_size,
                seed=self.seed,
                with_mask=self.with_mask,
                num_mask_classes=self.num_mask_classes,
                deterministic=self.deterministic,
            )

    def setup(self, stage: Optional[str] = None) -> None:
        # hermetic even if prepare_data was skipped; with several processes
        # only rank 0 writes the tree (concurrent writers tear its files) and
        # the others wait for it (JAX ``synthetic_module.py:111-125``)
        if process_index() == 0:
            self.prepare_data()
        host_barrier("synthetic_generate")
        self._inner.setup(stage)

    def train_dataloader(self):
        return self._inner.train_dataloader()

    def val_dataloader(self):
        return self._inner.val_dataloader()

    def test_dataloader(self):
        return self._inner.test_dataloader()


__all__ = ["SyntheticPairedDataModule"]

"""The port's mask and positive/negative data modules against the JAX
package's, on the CPU.

- ``load_mask_binary``: grayscale, nearest resize, ``> 1 → 1``, equal to JAX.
- ``generate_paired_dataset(with_mask=True)`` (binary and multiclass masks,
  the latter's extra draws on the same generator) and
  ``generate_pos_neg_layout`` write the JAX package's files byte for byte.
- ``PairedHEIHCDataModule``: the JAX datamodule's batches bit for bit, on
  one tree, through the native batch decoder where it loads and per tile.
- ``SyntheticPairedDataModule(with_mask=True)``: JAX's directory and batches.
- ``ConcatDataset`` and the loader's ``sampler_weights``, then
  ``PairedPosNegDataModule``'s weighted batches, bit for bit over two epochs.
"""

from __future__ import annotations

import filecmp
from pathlib import Path

import cv2
import numpy as np
import pytest

from stain2stain_tpu.data import DataLoader as JaxDataLoader
from stain2stain_tpu.data import PairedHEIHCDataModule as JaxMaskDataModule
from stain2stain_tpu.data import PairedPosNegDataModule as JaxPosNegDataModule
from stain2stain_tpu.data.base import ConcatDataset as JaxConcatDataset
from stain2stain_tpu.data.paired_data_mask import load_mask_binary as j_load_mask_binary
from stain2stain_tpu.data.synthetic import generate_paired_dataset as j_generate_paired_dataset
from stain2stain_tpu.data.synthetic import generate_pos_neg_layout as j_generate_pos_neg_layout
from stain2stain_tpu.data.synthetic_module import SyntheticPairedDataModule as JaxSyntheticDataModule
from stain2stain_tpu_torch.data import (
    ConcatDataset,
    DataLoader,
    PairedHEIHCDataModule,
    PairedPosNegDataModule,
    load_mask_binary,
    native,
)
from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset, generate_pos_neg_layout
from stain2stain_tpu_torch.data.synthetic_module import SyntheticPairedDataModule


def _tree_files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _assert_same_tree(a: Path, b: Path) -> None:
    names = _tree_files(a)
    assert names == _tree_files(b) and names
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _assert_same_batches(port_loader, jax_loader, epochs=(0, 1)) -> None:
    for epoch in epochs:
        port_loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, ref = list(port_loader), list(jax_loader)
        assert len(got) == len(ref) == len(port_loader) > 0
        for g, r in zip(got, ref):
            assert len(g) == len(r)
            for x, y in zip(g, r):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


# -------------------------------------------------------------------- masks


def test_load_mask_binary_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    # grey levels around the threshold (0, 1, 2, 255) and a resize both ways
    mask = rng.choice(np.array([0, 1, 2, 3, 128, 255], np.uint8), size=(23, 23))
    path = str(tmp_path / "mask.png")
    cv2.imwrite(path, mask)
    for size in (23, 16, 40):
        got, ref = load_mask_binary(path, size), j_load_mask_binary(path, size)
        assert got.dtype == np.uint8 and got.shape == (size, size)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(load_mask_binary(path, 23), (mask > 1).astype(np.uint8))


@pytest.mark.parametrize("num_mask_classes", [0, 3], ids=["binary", "multiclass"])
def test_masked_synthetic_tree_matches_jax_byte_for_byte(tmp_path, num_mask_classes):
    kw = dict(n_train=4, n_val=2, n_test=2, size=24, seed=3, with_mask=True, num_mask_classes=num_mask_classes)
    root = generate_paired_dataset(tmp_path / "port", **kw)
    j_root = j_generate_paired_dataset(tmp_path / "jax", **kw)
    _assert_same_tree(root, j_root)
    mask = cv2.imread(str(root / "train" / "train_0000_mask.png"), cv2.IMREAD_GRAYSCALE)
    assert set(np.unique(mask)) <= ({0, 255} if num_mask_classes == 0 else {0, 1, 2})


def test_pos_neg_layout_matches_jax_byte_for_byte(tmp_path):
    kw = dict(n_pos_train=5, n_neg=3, n_val=2, n_test=2, size=24, seed=1)
    root = generate_pos_neg_layout(tmp_path / "port", **kw)
    j_root = j_generate_pos_neg_layout(tmp_path / "jax", **kw)
    _assert_same_tree(root, j_root)
    assert sorted(p.name for p in (root / "train_he").iterdir()) == ["neg_0000.png", "neg_0001.png", "neg_0002.png"]


@pytest.mark.parametrize("decoder", ["native", "per_tile"])
@pytest.mark.parametrize("image_size", [24, 16], ids=["same_size", "resized"])
def test_mask_datamodule_batches_match_jax(tmp_path, monkeypatch, decoder, image_size):
    if decoder == "native" and not native.available():
        pytest.skip("the native decoder library does not load here")
    if decoder == "per_tile":
        monkeypatch.setenv("S2S_DISABLE_NATIVE", "1")
    root = generate_paired_dataset(tmp_path / "tiles", n_train=7, n_val=3, n_test=2, size=24, seed=5,
                                   with_mask=True)
    kw = dict(data_dir=str(root), csv_file_name="metadata.csv", batch_size=3, num_workers=2, image_size=image_size,
              seed=4)
    dm, jdm = PairedHEIHCDataModule(**kw), JaxMaskDataModule(**kw)
    dm.setup("fit")
    jdm.setup("fit")
    assert dm.field_kinds == jdm.field_kinds == ("image", "image", "mask")
    assert dm.train_augment is None and jdm.train_augment is None
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader()),
                                    (dm.test_dataloader(), jdm.test_dataloader())):
        _assert_same_batches(port_loader, jax_loader)
    he, ihc, mask = next(iter(dm.val_dataloader()))
    assert mask.shape == (3, image_size, image_size, 1) and set(np.unique(mask)) <= {0, 1}
    # the reverse direction swaps the stains, the mask stays
    swapped = PairedHEIHCDataModule(**kw, direction="IHC_to_HE")
    swapped.setup("fit")
    s_he, s_ihc, s_mask = next(iter(swapped.val_dataloader()))
    np.testing.assert_array_equal(s_he, ihc)
    np.testing.assert_array_equal(s_ihc, he)
    np.testing.assert_array_equal(s_mask, mask)


def test_synthetic_module_with_mask_matches_jax(tmp_path):
    kw = dict(n_train=6, n_val=3, n_test=2, tile_size=24, image_size=16, batch_size=2, num_workers=2, with_mask=True)
    dm = SyntheticPairedDataModule(data_dir=str(tmp_path / "port"), **kw)
    jdm = JaxSyntheticDataModule(data_dir=str(tmp_path / "jax"), **kw)
    assert dm.data_dir.name == jdm.data_dir.name == "s24_m0_n6-3-2_seed0"
    dm.setup("fit")
    jdm.setup("fit")
    _assert_same_tree(dm.data_dir, jdm.data_dir)
    assert dm.field_kinds == ("image", "image", "mask") and dm.train_augment is None
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader())):
        _assert_same_batches(port_loader, jax_loader)
    with pytest.raises(NotImplementedError, match="multitask"):
        SyntheticPairedDataModule(data_dir=str(tmp_path), with_mask=True, num_mask_classes=3)


# ------------------------------------------------------------ pos/neg data


class _Rows:
    """A dataset of (value,) rows: index ``i`` of part ``k`` is ``100·k + i``."""

    def __init__(self, part: int, n: int):
        self.part, self.n, self.epochs = part, n, []

    def set_epoch(self, epoch: int) -> None:
        self.epochs.append(epoch)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> tuple:
        if not 0 <= idx < self.n:
            raise IndexError(idx)
        return (np.array([100 * self.part + idx], np.int32),)


def test_concat_dataset_and_weighted_sampling_match_jax():
    parts = [_Rows(0, 6), _Rows(1, 2)]
    ds, jds = ConcatDataset(parts), JaxConcatDataset(parts)
    assert len(ds) == len(jds) == 8
    assert [ds[i][0][0] for i in range(8)] == [jds[i][0][0] for i in range(8)] == [0, 1, 2, 3, 4, 5, 100, 101]
    ds.set_epoch(3)
    assert [p.epochs for p in parts] == [[3], [3]]
    weights = np.concatenate([np.full(6, 1 / 6), np.full(2, 1 / 2)])
    loader = DataLoader(ds, batch_size=4, shuffle=True, drop_last=True, num_workers=2, seed=9,
                        sampler_weights=weights)
    jloader = JaxDataLoader(jds, batch_size=4, shuffle=True, drop_last=True, num_workers=2, seed=9,
                            sampler_weights=weights)
    _assert_same_batches(loader, jloader, epochs=(0, 1, 2))
    drawn = []
    for epoch in range(4):
        loader.set_epoch(epoch)
        drawn.extend(b[0][:, 0] for b in loader)
    drawn = np.concatenate(drawn)
    # balanced: the two negatives make about half the draws, with replacement
    assert 0.3 < np.mean(drawn >= 100) < 0.7


@pytest.mark.parametrize("use_negative_data", [True, False], ids=["pos_neg", "positive_only"])
def test_pos_neg_datamodule_batches_match_jax(tmp_path, use_negative_data):
    root = generate_pos_neg_layout(tmp_path / "tiles", n_pos_train=6, n_neg=3, n_val=3, n_test=2, size=32, seed=2)
    kw = dict(data_dir=str(root), csv_file_name="metadata.csv", negative_data_dir=str(root), batch_size=3,
              num_workers=2, image_size=24, crop_size=28, use_negative_data=use_negative_data, seed=5)
    dm, jdm = PairedPosNegDataModule(**kw), JaxPosNegDataModule(**kw)
    dm.setup("fit")
    jdm.setup("fit")
    assert dm.field_kinds == jdm.field_kinds and dm.train_augment is None
    assert len(dm.data_train) == len(jdm.data_train) == (9 if use_negative_data else 6)
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader()),
                                    (dm.test_dataloader(), jdm.test_dataloader())):
        _assert_same_batches(port_loader, jax_loader)
    if use_negative_data:
        np.testing.assert_allclose(dm.train_weights, np.concatenate([np.full(6, 1 / 6), np.full(3, 1 / 3)]))
        # the negatives' crops move with the epoch
        negative = dm.data_train.datasets[1]
        negative.set_epoch(0)
        first = [negative[i][0] for i in range(len(negative))]
        negative.set_epoch(1)
        assert first[0].shape == (24, 24, 3)
        assert any(not np.array_equal(a, negative[i][0]) for i, a in enumerate(first))
    else:
        assert dm.train_weights is None

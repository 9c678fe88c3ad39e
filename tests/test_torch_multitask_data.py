"""The port's multiclass-mask data against the JAX package's, on the CPU.

- ``load_class_mask``: grayscale class ids, nearest resize only when the
  size differs, int32, equal to JAX's loader.
- ``generate_paired_dataset(num_mask_classes=2)`` and
  ``SyntheticPairedDataModule(num_mask_classes=2)``: JAX's directory name,
  files byte for byte and batches bit for bit.
- ``PairedMulticlassDataModule``: the JAX datamodule's batches bit for bit,
  through the native batch decoder and per tile, at the tile size and
  resized, with and without augmentation (the test loader never augments);
  the direction swap; the ids stay int32 through the collate and the device
  cache.
"""

from __future__ import annotations

import filecmp
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from stain2stain_tpu.data import PairedMulticlassDataModule as JaxMulticlassDataModule
from stain2stain_tpu.data.paired_data_multiclassmask import PairedMulticlassDataset as JaxMulticlassDataset
from stain2stain_tpu.data.synthetic import generate_paired_dataset as j_generate_paired_dataset
from stain2stain_tpu.data.synthetic_module import SyntheticPairedDataModule as JaxSyntheticDataModule
from stain2stain_tpu_torch.data import DataLoader, PairedMulticlassDataModule, load_class_mask, native
from stain2stain_tpu_torch.data import device_cache as tdevice_cache
from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset
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
            assert len(g) == len(r) == 3
            for x, y in zip(g, r):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            assert g[2].dtype == np.int32 and g[2].ndim == 3


def _multiclass_tree(root: Path, seed: int = 5) -> Path:
    return generate_paired_dataset(root, n_train=7, n_val=3, n_test=2, size=24, seed=seed, with_mask=True,
                                   num_mask_classes=2)


def test_load_class_mask_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    ids = rng.choice(np.array([0, 1, 2, 3], np.uint8), size=(23, 23))
    path = str(tmp_path / "mask.png")
    cv2.imwrite(path, ids)
    for size in (23, 16, 40):
        got, ref = load_class_mask(path, size), JaxMulticlassDataset._load_class_mask(None, path, size)
        assert got.dtype == np.int32 and got.shape == (size, size)
        np.testing.assert_array_equal(got, ref)
        assert set(np.unique(got)) <= {0, 1, 2, 3}
    np.testing.assert_array_equal(load_class_mask(path, 23), ids.astype(np.int32))


def test_two_class_synthetic_tree_and_module_match_jax(tmp_path):
    kw = dict(n_train=6, n_val=3, n_test=2, size=24, seed=3, with_mask=True, num_mask_classes=2)
    _assert_same_tree(generate_paired_dataset(tmp_path / "tree_port", **kw),
                      j_generate_paired_dataset(tmp_path / "tree_jax", **kw))
    mkw = dict(n_train=6, n_val=3, n_test=2, tile_size=24, image_size=16, batch_size=2, num_workers=2,
               with_mask=True, num_mask_classes=2)
    dm = SyntheticPairedDataModule(data_dir=str(tmp_path / "port"), **mkw)
    jdm = JaxSyntheticDataModule(data_dir=str(tmp_path / "jax"), **mkw)
    assert dm.data_dir.name == jdm.data_dir.name == "s24_m2_n6-3-2_seed0"
    dm.setup("fit")
    jdm.setup("fit")
    _assert_same_tree(dm.data_dir, jdm.data_dir)
    assert dm.field_kinds == tuple(jdm.field_kinds) == ("image", "image", "class_mask")
    assert dm.train_augment == jdm.train_augment == {"crop_size": 16, "hflip": True, "vflip": True}
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader())):
        _assert_same_batches(port_loader, jax_loader)
    train_ids = next(iter(dm.train_dataloader()))[2]
    assert train_ids.shape == (2, 24, 24) and set(np.unique(train_ids)) <= {0, 1}  # decoded at the tile size


@pytest.mark.parametrize("augment", [False, True], ids=["resize", "augment"])
@pytest.mark.parametrize("decoder", ["native", "per_tile"])
@pytest.mark.parametrize("image_size", [24, 16], ids=["same_size", "resized"])
def test_multiclass_datamodule_batches_match_jax(tmp_path, monkeypatch, decoder, image_size, augment):
    if decoder == "native" and not native.available():
        pytest.skip("the native decoder library does not load here")
    if decoder == "per_tile":
        monkeypatch.setenv("S2S_DISABLE_NATIVE", "1")
    root = _multiclass_tree(tmp_path / "tiles")
    kw = dict(data_dir=str(root), csv_file_name="metadata.csv", target_column="ihc_filepath", batch_size=3,
              num_workers=2, image_size=image_size, seed=4, use_augmentation=augment,
              load_size=24 if augment else None)
    dm, jdm = PairedMulticlassDataModule(**kw), JaxMulticlassDataModule(**kw)
    dm.setup("fit")
    jdm.setup("fit")
    assert dm.field_kinds == jdm.field_kinds == ("image", "image", "class_mask")
    assert dm.train_augment == jdm.train_augment
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader()),
                                    (dm.test_dataloader(), jdm.test_dataloader())):
        _assert_same_batches(port_loader, jax_loader)
    # the test loader never augments: tiles at image_size
    assert next(iter(dm.test_dataloader()))[0].shape == (2, image_size, image_size, 3)
    if augment:
        assert next(iter(dm.train_dataloader()))[2].shape == (3, 24, 24)
    # the reverse direction swaps the stains, the mask stays
    swapped = PairedMulticlassDataModule(**kw, direction="T2S")
    swapped.setup("fit")
    (src, tgt, ids), (s_src, s_tgt, s_ids) = next(iter(dm.val_dataloader())), next(iter(swapped.val_dataloader()))
    np.testing.assert_array_equal(s_src, tgt)
    np.testing.assert_array_equal(s_tgt, src)
    np.testing.assert_array_equal(s_ids, ids)


def test_device_cache_keeps_the_ids_integral(tmp_path, monkeypatch):
    """The device cache gathers the streaming loader's batches, ids int32
    (its device resolved to the CPU here; on the card it is the CUDA device)."""
    monkeypatch.setattr(tdevice_cache, "resolve_device", lambda device=None: torch.device("cpu"))
    root = _multiclass_tree(tmp_path / "tiles", seed=6)
    dm = PairedMulticlassDataModule(data_dir=str(root), csv_file_name="metadata.csv", target_column="ihc_filepath",
                                    batch_size=2, num_workers=2, image_size=16, cache="device")
    dm.setup("fit")
    cached = dm.train_dataloader()
    assert isinstance(cached, tdevice_cache.DeviceCacheLoader)
    streamed = DataLoader(dm.datasets["train"], batch_size=2, shuffle=True, drop_last=True, seed=0)
    for epoch in (0, 1):
        cached.set_epoch(epoch)
        streamed.set_epoch(epoch)
        for c, s in zip(cached, streamed):
            assert c[2].dtype == torch.int32 and s[2].dtype == np.int32
            for x, y in zip(c, s):
                np.testing.assert_array_equal(x.numpy(), y)

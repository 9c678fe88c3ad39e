"""Synthetic paired-tile fixtures (the port's copy of ``stain2stain_tpu/data/synthetic.py``).

Deterministic fake histology tile pairs — smoothly varying colour fields, a
stain-like colour transform and blob masks — written as PNGs plus a metadata
CSV, so the training path runs end to end with no dataset. The numpy
generator is the JAX package's, so the same seed gives the same pixels.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np


def _smooth_noise(rng: np.random.Generator, size: int, scale: int = 4) -> np.ndarray:
    """Low-frequency noise field in [0,1] (tissue-ish structure)."""
    coarse = rng.random((scale, scale))
    idx = np.linspace(0, scale - 1, size)
    xi, yi = np.meshgrid(idx, idx)
    x0, y0 = np.floor(xi).astype(int), np.floor(yi).astype(int)
    x1, y1 = np.minimum(x0 + 1, scale - 1), np.minimum(y0 + 1, scale - 1)
    fx, fy = xi - x0, yi - y0
    return (
        coarse[y0, x0] * (1 - fx) * (1 - fy)
        + coarse[y0, x1] * fx * (1 - fy)
        + coarse[y1, x0] * (1 - fx) * fy
        + coarse[y1, x1] * fx * fy
    )


def make_tile_pair(
    rng: np.random.Generator, size: int, deterministic: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (he_like, ihc_like, blob_mask) — uint8 RGB ×2 and uint8 {0,1} mask.

    ``deterministic=True`` makes the target an exact function of the source
    (the blob mask comes from the shared structure field), the noise-free
    control of the quality experiments.
    """
    base = _smooth_noise(rng, size)
    texture = 0.15 * rng.random((size, size))
    field = np.clip(base + texture, 0, 1)
    he = np.stack([0.7 + 0.25 * field, 0.4 + 0.3 * (1 - field), 0.75 + 0.2 * field], axis=-1)
    if deterministic:
        mask = (field > 0.62).astype(np.uint8)
    else:
        mask = (_smooth_noise(rng, size, scale=3) > 0.65).astype(np.uint8)
    brown = np.stack([0.55 * np.ones_like(field), 0.35 * np.ones_like(field), 0.2 * np.ones_like(field)], axis=-1)
    ihc = np.stack([0.85 - 0.2 * field, 0.8 - 0.25 * field, 0.75 - 0.2 * field], axis=-1)
    ihc = np.where(mask[..., None] > 0, brown, ihc)

    def to_u8(x):
        return (np.clip(x, 0, 1) * 255).astype(np.uint8)

    return to_u8(he), to_u8(ihc), mask


def generate_paired_dataset(
    root: str | Path,
    n_train: int = 8,
    n_val: int = 4,
    n_test: int = 4,
    size: int = 64,
    seed: int = 0,
    with_mask: bool = False,
    num_mask_classes: int = 0,
    csv_name: str = "metadata.csv",
    deterministic: bool = False,
) -> Path:
    """Write ``root/{train,val,test}/*.png`` and the metadata CSV; returns root.

    ``with_mask`` adds ``<stem>_mask.png`` under both mask columns
    (``amyloid_filepath``, ``graywhite_filepath``): the blob mask × 255, or
    with ``num_mask_classes > 1`` the blob mask × one class id in
    [1, num_mask_classes) drawn per tile from the same generator. The files
    are the JAX package's byte for byte (the CSV as pandas writes it).
    """
    import cv2

    root = Path(root)
    rng = np.random.default_rng(seed)
    rows = []
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        split_dir = root / split
        split_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            he, ihc, mask = make_tile_pair(rng, size, deterministic=deterministic)
            stem = f"{split}_{i:04d}"
            he_name, ihc_name = f"{stem}_he.png", f"{stem}_ihc.png"
            cv2.imwrite(str(split_dir / he_name), cv2.cvtColor(he, cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(split_dir / ihc_name), cv2.cvtColor(ihc, cv2.COLOR_RGB2BGR))
            row = {"image_id": stem, "he_filepath": he_name, "ihc_filepath": ihc_name, "split": split}
            if with_mask:
                mask_name = f"{stem}_mask.png"
                if num_mask_classes > 1:
                    class_mask = (mask * rng.integers(1, num_mask_classes, size=1)[0]).astype(np.uint8)
                    cv2.imwrite(str(split_dir / mask_name), class_mask)
                else:
                    cv2.imwrite(str(split_dir / mask_name), mask * 255)
                row["amyloid_filepath"] = mask_name
                row["graywhite_filepath"] = mask_name
            rows.append(row)
    tmp = root / f"{csv_name}.tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]) if rows else [], lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    tmp.replace(root / csv_name)  # the CSV appears last, once every tile is written
    return root


def generate_domain_folders(
    root: str | Path,
    domains: tuple[str, ...] = ("HE", "IHC", "Grayscale"),
    n_images: int = 8,
    size: int = 64,
    seed: int = 0,
) -> Path:
    """The any2any layout: ``root/<domain>/<shared filename>`` per domain, a
    grayscale view of the H&E tile as the third stain."""
    import cv2

    root = Path(root)
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        he, ihc, _ = make_tile_pair(rng, size)
        gray = np.repeat(
            (0.3 * he[..., 0] + 0.6 * he[..., 1] + 0.1 * he[..., 2]).astype(np.uint8)[..., None], 3, axis=-1
        )
        views = {"HE": he, "IHC": ihc, "Grayscale": gray}
        fname = f"tile_{i:04d}.png"
        for dom in domains:
            (root / dom).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(root / dom / fname), cv2.cvtColor(views.get(dom, he), cv2.COLOR_RGB2BGR))
    return root


def generate_pos_neg_layout(
    root: str | Path,
    n_pos_train: int = 8,
    n_neg: int = 4,
    n_val: int = 4,
    n_test: int = 4,
    size: int = 64,
    seed: int = 0,
) -> Path:
    """The positive/negative layout: a positive CSV dataset
    (:func:`generate_paired_dataset`) and the ``train_he`` / ``train_ihc``
    folders of negative pairs under shared file names, drawn from ``seed + 1``."""
    import cv2

    root = Path(root)
    generate_paired_dataset(root, n_train=n_pos_train, n_val=n_val, n_test=n_test, size=size, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(n_neg):
        he, ihc, _ = make_tile_pair(rng, size)
        fname = f"neg_{i:04d}.png"
        for sub, img in (("train_he", he), ("train_ihc", ihc)):
            (root / sub).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(root / sub / fname), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return root


__all__ = ["generate_paired_dataset", "generate_domain_folders", "generate_pos_neg_layout", "make_tile_pair"]

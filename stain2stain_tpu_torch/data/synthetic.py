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
    csv_name: str = "metadata.csv",
    deterministic: bool = False,
) -> Path:
    """Write ``root/{train,val,test}/*.png`` and the metadata CSV; returns root."""
    import cv2

    root = Path(root)
    rng = np.random.default_rng(seed)
    rows = []
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        split_dir = root / split
        split_dir.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            he, ihc, _ = make_tile_pair(rng, size, deterministic=deterministic)
            stem = f"{split}_{i:04d}"
            he_name, ihc_name = f"{stem}_he.png", f"{stem}_ihc.png"
            cv2.imwrite(str(split_dir / he_name), cv2.cvtColor(he, cv2.COLOR_RGB2BGR))
            cv2.imwrite(str(split_dir / ihc_name), cv2.cvtColor(ihc, cv2.COLOR_RGB2BGR))
            rows.append({"image_id": stem, "he_filepath": he_name, "ihc_filepath": ihc_name, "split": split})
    tmp = root / f"{csv_name}.tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["image_id", "he_filepath", "ihc_filepath", "split"])
        writer.writeheader()
        writer.writerows(rows)
    tmp.replace(root / csv_name)  # the CSV appears last, once every tile is written
    return root


__all__ = ["generate_paired_dataset", "make_tile_pair"]

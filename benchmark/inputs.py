"""The inputs of every run, made by the benchmark from ``--seed``: the net's
weights (by the names and shapes of the configuration's reference net), the
paired tile tree the training recipe reads, and the regions a serving run
posts. The program under test gets only these; the plain reference gets the
same.
"""

from __future__ import annotations

import csv
import io
from pathlib import Path
from typing import Callable, Optional

import numpy as np


def make_weights(names_shapes: list, seed: int, device, zeroed: Optional[Callable[[str], bool]] = None,
                 jitter: float = 0.02) -> dict:
    """{name: f32 tensor} for a net's parameters, drawn on ``device`` in one
    call from a generator seeded with ``seed``.

    Each conv and dense kernel is normal with variance 1/fan_in, as the
    recipes initialize them; the kernels the recipe zeroes (those for which
    ``zeroed(name)``, the reference module's, is true; by default none) and
    every bias are normal with deviation ``jitter``, and each norm scale (a
    one-dimensional ``weight``) is 1 plus that. So the velocity is not zero,
    and every parameter has a gradient."""
    import torch

    total = sum(int(np.prod(shape)) for _, shape in names_shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in names_shapes:
        n = int(np.prod(shape))
        z = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2 and not (zeroed is not None and zeroed(name)):
            out[name] = z * (n // shape[0]) ** -0.5
        elif len(shape) == 1 and name.endswith(".weight"):
            out[name] = 1.0 + jitter * z
        else:
            out[name] = jitter * z
    return out


def _smooth_noise(rng: np.random.Generator, size: int, scale: int = 4) -> np.ndarray:
    coarse = rng.random((scale, scale))
    idx = np.linspace(0, scale - 1, size)
    xi, yi = np.meshgrid(idx, idx)
    x0, y0 = np.floor(xi).astype(int), np.floor(yi).astype(int)
    x1, y1 = np.minimum(x0 + 1, scale - 1), np.minimum(y0 + 1, scale - 1)
    fx, fy = xi - x0, yi - y0
    return (coarse[y0, x0] * (1 - fx) * (1 - fy) + coarse[y0, x1] * fx * (1 - fy)
            + coarse[y1, x0] * (1 - fx) * fy + coarse[y1, x1] * fx * fy)


def tile_pair(rng: np.random.Generator, size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One noise-free (H&E-like, IHC-like, stained-region mask) uint8 triple:
    the target and the mask fixed functions of the source, as the quality
    recipe's tiles; the mask is 0 or 255."""
    field = np.clip(_smooth_noise(rng, size) + 0.15 * rng.random((size, size)), 0, 1)
    he = np.stack([0.7 + 0.25 * field, 0.4 + 0.3 * (1 - field), 0.75 + 0.2 * field], axis=-1)
    brown = np.broadcast_to(np.array([0.55, 0.35, 0.2]), he.shape)
    ihc = np.stack([0.85 - 0.2 * field, 0.8 - 0.25 * field, 0.75 - 0.2 * field], axis=-1)
    stained = field > 0.62
    ihc = np.where(stained[..., None], brown, ihc)
    he, ihc = ((np.clip(x, 0, 1) * 255).astype(np.uint8) for x in (he, ihc))
    return he, ihc, stained.astype(np.uint8) * 255


def tile_tree(spec: dict, cache: Path) -> Path:
    """The tree ``spec`` describes (``n_train``, ``n_val``, ``n_test``,
    ``size``, ``seed``, optionally ``mask``) under ``cache``:
    ``<split>/<split>_<i>_{he,ihc[,mask]}.png`` and ``metadata.csv``
    (``he_filepath``, ``ihc_filepath``[, ``amyloid_filepath``], ``split``).
    Written once; a tree whose CSV exists is reused."""
    from PIL import Image

    masked = bool(spec.get("mask", False))
    root = cache / "tiles-{n_train}-{n_val}-{n_test}-{size}px-seed{seed}".format(**spec)
    root = root.with_name(root.name + ("-mask" if masked else ""))
    if (root / "metadata.csv").exists():
        return root
    rng = np.random.default_rng(int(spec["seed"]))
    rows = []
    for split in ("train", "val", "test"):
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(int(spec[f"n_{split}"])):
            he, ihc, mask = tile_pair(rng, int(spec["size"]))
            names = [f"{split}_{i:04d}_{kind}.png" for kind in ("he", "ihc", "mask")[: 2 + masked]]
            for img, name in zip((he, ihc, mask), names):
                Image.fromarray(img).save(root / split / name, compress_level=1)
            row = {"he_filepath": names[0], "ihc_filepath": names[1]}
            if masked:
                row["amyloid_filepath"] = names[2]
            rows.append({**row, "split": split})
    tmp = root / "metadata.csv.tmp"
    with open(tmp, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    tmp.replace(root / "metadata.csv")  # last: a tree cut off midway is written again
    return root


def read_split(root: Path, split: str) -> list[tuple]:
    """(source, target[, mask]) file names of a split, in the CSV's order."""
    with open(root / "metadata.csv", newline="") as f:
        return [tuple(r[k] for k in ("he_filepath", "ihc_filepath", "amyloid_filepath") if k in r)
                for r in csv.DictReader(f) if r["split"] == split]


def decode_png(path_or_bytes) -> np.ndarray:
    from PIL import Image

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) else path_or_bytes
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"))


def encode_png(img: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def region_sizes(traffic: dict) -> list[tuple[int, int]]:
    """The traffic's block of region sizes: ``block`` (h, w) pairs on a
    stratified grid over [``min_px``, ``max_px``], fixed by the traffic's
    own ``sizes_seed``. Every run posts this same block over and over, each
    time in an order drawn from its seed, so every seed sends the same work."""
    n, lo, hi = int(traffic["block"]), int(traffic["min_px"]), int(traffic["max_px"])
    rng = np.random.default_rng(int(traffic["sizes_seed"]))
    strata = (np.arange(n) + rng.random(n)) / n
    heights = lo + np.floor(strata * (hi - lo + 1)).astype(int)
    widths = lo + np.floor(rng.permutation(strata) * (hi - lo + 1)).astype(int)
    return [(int(h), int(w)) for h, w in zip(heights, widths)]


def region_image(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """A tissue-like uint8 RGB region: smooth stain fields and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.random(3) * 6.28
    base = np.stack([128 + 90 * np.sin(xx / 37.0 + phase[c]) * np.cos(yy / 23.0 - phase[c]) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def region_schedule(traffic: dict, seed: int, blocks: int) -> list[int]:
    """Indices into :func:`region_sizes` for ``blocks`` blocks, each block a
    permutation drawn from ``seed``."""
    rng = np.random.default_rng(int(seed))
    n = int(traffic["block"])
    return [int(i) for _ in range(blocks) for i in rng.permutation(n)]

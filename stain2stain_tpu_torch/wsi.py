"""Whole-slide-image inference: tile → batched generate → feather-stitch.

Counterpart of ``stain2stain_tpu/wsi.py``, with its own copies of the numpy
helpers. One fixed batch shape ``(batch, tile, tile, C)`` serves every tile
of every image: the last partial batch is zero-padded and the padding rows
are dropped. Overlap seams are feather-blended: each tile's weight ramps
linearly from 1/(overlap+1) at its edge to 1 inside, and the accumulated
output is divided by the accumulated weight.

Under a traced root (:mod:`.utils.tracing`, e.g. the server's
``serve.request``) each tile batch is a ``wsi.batch`` span with the
attributes ``tiles`` (real tiles) and ``slots`` (the fixed batch size), and
holds ``wsi.gather`` (stack and padding), the generator's ``wsi.h2d``,
``wsi.generate`` and ``wsi.d2h`` (the copy back, with the wait for the card)
and ``wsi.stitch`` (the feather accumulation).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .utils import tracing

__all__ = [
    "tile_starts",
    "feather_weights",
    "translate_large_image",
    "make_tiled_generator",
    "make_conditioned_tiled_generator",
]


def tile_starts(length: int, tile: int, stride: int) -> list[int]:
    """Window starts covering ``[0, length)`` with step ``stride``; the last
    window is edge-aligned so coverage is exact without ragged shapes."""
    if length <= tile:
        return [0]
    starts = list(range(0, length - tile + 1, stride))
    if starts[-1] != length - tile:
        starts.append(length - tile)
    return starts


def feather_weights(tile: int, overlap: int) -> np.ndarray:
    """(tile, tile, 1) f32 blending weights: linear ramp over the ``overlap``
    margin, 1 in the interior, strictly positive everywhere."""
    ramp = np.ones(tile, np.float32)
    for i in range(min(overlap, tile // 2)):
        w = (i + 1) / (overlap + 1)
        ramp[i] = w
        ramp[tile - 1 - i] = w
    return (ramp[:, None] * ramp[None, :])[..., None]


def translate_large_image(
    generate_fn: Callable[[np.ndarray], np.ndarray],
    image: np.ndarray,
    tile: int = 256,
    overlap: int = 32,
    batch_size: int = 16,
) -> np.ndarray:
    """Translate an (H, W, C) image of arbitrary size with a fixed-shape
    batched ``generate_fn``: ``(batch_size, tile, tile, C) -> (batch_size,
    tile, tile, C')`` in the model's normalized domain. Returns (H, W, C') f32.
    """
    if image.ndim != 3:
        raise ValueError(f"expected (H, W, C) image, got shape {image.shape}")
    if not 0 <= overlap < tile:
        raise ValueError(f"overlap must be in [0, tile); got {overlap} vs tile {tile}")
    h, w, _ = image.shape
    pad_h, pad_w = max(0, tile - h), max(0, tile - w)
    if pad_h or pad_w:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")
    hp, wp, _ = image.shape

    stride = tile - overlap
    coords = [(y, x) for y in tile_starts(hp, tile, stride) for x in tile_starts(wp, tile, stride)]
    weights = feather_weights(tile, overlap)

    out: Optional[np.ndarray] = None
    wsum = np.zeros((hp, wp, 1), np.float32)
    for i in range(0, len(coords), batch_size):
        chunk = coords[i : i + batch_size]
        with tracing.span("wsi.batch", tiles=len(chunk), slots=batch_size):
            with tracing.span("wsi.gather"):
                batch = np.stack([image[y : y + tile, x : x + tile] for y, x in chunk])
                if len(chunk) < batch_size:  # pad to the fixed batch shape
                    pad = np.zeros((batch_size - len(chunk),) + batch.shape[1:], batch.dtype)
                    batch = np.concatenate([batch, pad])
            gen = np.asarray(generate_fn(batch), np.float32)
            with tracing.span("wsi.stitch"):
                if out is None:
                    out = np.zeros((hp, wp, gen.shape[-1]), np.float32)
                for (y, x), g in zip(chunk, gen):
                    out[y : y + tile, x : x + tile] += g * weights
                    wsum[y : y + tile, x : x + tile] += weights
    if out is None:
        raise RuntimeError("no tiles were generated")
    return (out / wsum)[:h, :w]


def _image(result):
    """The translated image of a ``generate`` result (JAX ``wsi.py:121, :131``)."""
    return result[0] if isinstance(result, tuple) else result


def _bind(task, gen_kwargs: dict) -> dict:
    """``gen_kwargs`` with each array condition (numpy or torch, e.g. ``mask=``)
    moved to ``task.device`` once, when the generator is built."""
    return {k: torch.as_tensor(v).to(task.device) if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in gen_kwargs.items()}


def make_tiled_generator(task, num_steps: int, **gen_kwargs) -> Callable[[np.ndarray], np.ndarray]:
    """``task.generate`` as a batched tile translator on numpy arrays.

    Each fixed-shape numpy batch moves to ``task.device``, runs through
    ``generate`` and comes back as an f32 numpy array. A multitask task's
    ``(image, mask)`` comes back as the image. ``gen_kwargs`` are bound into
    every ``generate`` call (JAX ``wsi.py:110-134``): ``target_class=2`` for a
    fixed-class any2any run, or ``mask=`` of the tile batch's shape for a
    mask-conditioned task; for a class chosen per call use
    :func:`make_conditioned_tiled_generator`.
    """
    bound = _bind(task, gen_kwargs)

    def gen(batch: np.ndarray) -> np.ndarray:
        with tracing.span("wsi.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(task.device)
        with tracing.span("wsi.generate"):
            out = task.generate(x, num_steps=num_steps, **bound)
        with tracing.span("wsi.d2h"):
            return _image(out).to(torch.float32).cpu().numpy()

    return gen


def make_conditioned_tiled_generator(task, num_steps: int, **gen_kwargs) -> Callable[[np.ndarray, int], np.ndarray]:
    """The class-conditioned variant, ``gen(batch, target_class)``: one
    generator serves every target stain, the class chosen per call; the
    other conditions are bound as in :func:`make_tiled_generator`."""
    bound = _bind(task, gen_kwargs)

    def gen(batch: np.ndarray, target_class: int) -> np.ndarray:
        with tracing.span("wsi.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(batch, np.float32)).to(task.device)
        with tracing.span("wsi.generate"):
            out = task.generate(x, num_steps=num_steps, target_class=int(target_class), **bound)
        with tracing.span("wsi.d2h"):
            return _image(out).to(torch.float32).cpu().numpy()

    return gen

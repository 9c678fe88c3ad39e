"""Image normalization and paired augmentation (counterpart of
``stain2stain_tpu/ops/image.py``).

Pixels map uint8 [0, 255] → float32 [-1, 1] (mean/std 0.5) and back to
[0, 1]. The numpy twins serve the whole-slide and serving paths, which must
not move arbitrarily large images to the device. Layout: NHWC.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def normalize_uint8(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] → float32 [-1, 1] ((x/255 - 0.5) / 0.5)."""
    return img.to(torch.float32) / 127.5 - 1.0


def denormalize(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] → [0, 1], clipped."""
    return torch.clamp((img + 1.0) * 0.5, 0.0, 1.0)


def normalize_uint8_np(img) -> np.ndarray:
    """Host-side (numpy) twin of :func:`normalize_uint8`."""
    return np.asarray(img, np.float32) / 127.5 - 1.0


def denormalize_np(img) -> np.ndarray:
    """Host-side (numpy) twin of :func:`denormalize`."""
    return np.clip((np.asarray(img, np.float32) + 1.0) * 0.5, 0.0, 1.0)


def paired_random_crop_flip(
    images: Sequence[torch.Tensor],
    crop_size: int,
    hflip: bool = True,
    vflip: bool = True,
    generator: Optional[torch.Generator] = None,
    tops: Optional[torch.Tensor] = None,
    lefts: Optional[torch.Tensor] = None,
    flip_h: Optional[torch.Tensor] = None,
    flip_v: Optional[torch.Tensor] = None,
) -> list[torch.Tensor]:
    """One *shared* random crop + flips over a group of (B, H, W, C) tensors
    (``stain2stain_tpu/ops/image.py:53-80``).

    Per-example offsets and flip bits are drawn once from ``generator`` (on
    its device, the CPU by default) and applied identically to every tensor,
    so source, target and mask stay aligned. Each of them can be passed in
    instead (the tests hand both packages the same draws).
    """
    ref = images[0]
    batch, height, width = ref.shape[0], ref.shape[1], ref.shape[2]
    gdev = generator.device if generator is not None else "cpu"

    def draw_int(high: int) -> torch.Tensor:
        return torch.randint(0, high, (batch,), generator=generator, device=gdev)

    def draw_bit(enabled: bool) -> torch.Tensor:
        if not enabled:
            return torch.zeros((batch,), dtype=torch.bool)
        return torch.rand((batch,), generator=generator, device=gdev) < 0.5

    if tops is None:
        tops = draw_int(max(height - crop_size, 0) + 1)
    if lefts is None:
        lefts = draw_int(max(width - crop_size, 0) + 1)
    if flip_h is None:
        flip_h = draw_bit(hflip)
    if flip_v is None:
        flip_v = draw_bit(vflip)
    device = ref.device
    ar = torch.arange(crop_size, device=device)
    tops, lefts = tops.to(device).reshape(batch, 1), lefts.to(device).reshape(batch, 1)
    flip_h, flip_v = flip_h.to(device).reshape(batch, 1), flip_v.to(device).reshape(batch, 1)
    # flip_v reverses the rows (H), flip_h the columns (W), after the crop
    rows = tops + torch.where(flip_v, crop_size - 1 - ar, ar)  # (B, crop)
    cols = lefts + torch.where(flip_h, crop_size - 1 - ar, ar)
    b_idx = torch.arange(batch, device=device)[:, None, None]
    return [img[b_idx, rows[:, :, None], cols[:, None, :]] for img in images]


__all__ = [
    "normalize_uint8",
    "denormalize",
    "normalize_uint8_np",
    "denormalize_np",
    "paired_random_crop_flip",
]

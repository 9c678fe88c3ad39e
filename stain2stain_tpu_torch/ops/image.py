"""Image normalization (counterpart of ``stain2stain_tpu/ops/image.py``).

Pixels map uint8 [0, 255] → float32 [-1, 1] (mean/std 0.5) and back to
[0, 1]. The numpy twins serve the whole-slide and serving paths, which must
not move arbitrarily large images to the device.
"""

from __future__ import annotations

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


__all__ = ["normalize_uint8", "denormalize", "normalize_uint8_np", "denormalize_np"]

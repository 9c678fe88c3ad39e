"""Space-to-batch 3×3 convolution (counterpart of ``stain2stain_tpu/ops/s2b_conv.py``).

A stride-1 SAME 3×3 conv of a batch-poor, spatially large input as one
VALID conv over a batch f² times as large: pad the input by one pixel, cut
it into f × f tiles that each carry a one-pixel halo (the neighbour pixels,
or the zero pad at the outer border), run one ``F.conv2d`` over the B·f²
tiles and stitch the outputs back. The result is the padding=1 conv up to
summation order. Autograd needs nothing of its own: the pad, slices and
reshapes differentiate into the halo scatter-add.

It is an opt-in path (``UNetModel(s2b_conv=f)``); its conv is cuDNN's, as
the JAX package's was XLA's, so it holds no hand-written kernel. On the card
it is measured against the plain conv by ``chip_smoke.py``'s ``train-s2b``
phase.

Layout is the port's: activations NCHW (B, C, H, W), weights torch's
(D, C, 3, 3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_batch_conv(x: torch.Tensor, weight: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """3×3 stride-1 SAME conv of ``x`` (B, C, H, W) with ``weight``
    (D, C, 3, 3), computed as a VALID conv over halo-padded tiles; H and W
    must be divisible by ``factor``. The product runs in ``x``'s dtype.
    Returns (B, D, H, W), equal to ``F.conv2d(x, weight, padding=1)`` up to
    summation order."""
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"space_to_batch_conv is specialised to 3x3, got {tuple(weight.shape[2:])}")
    b, _, h, w = x.shape
    f = int(factor)
    if h % f or w % f:
        raise ValueError(f"spatial dims {(h, w)} not divisible by factor {f}")
    th, tw = h // f, w // f
    xpad = F.pad(x, (1, 1, 1, 1))
    tiles = torch.cat(
        [xpad[:, :, i * th:i * th + th + 2, j * tw:j * tw + tw + 2] for i in range(f) for j in range(f)], dim=0
    )  # (f²·B, C, th + 2, tw + 2), tile-major
    y = F.conv2d(tiles, weight.to(x.dtype))  # (f²·B, D, th, tw)
    d = y.shape[1]
    return y.reshape(f, f, b, d, th, tw).permute(2, 3, 0, 4, 1, 5).reshape(b, d, h, w)


__all__ = ["space_to_batch_conv"]

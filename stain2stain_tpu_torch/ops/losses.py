"""Losses of the port's task modules (counterpart of ``stain2stain_tpu/ops/losses.py``).

NHWC, all math in f32, global sums as the reference reduces them:

- plain CFM MSE (``losses.py:27-29``);
- ROI-upweighted MSE, w = 1 + λ·mask (``:32-46``);
- Charbonnier and its ROI mean (``:49-61``).

Masks are (B, H, W, 1) in [0, 1]; their weights broadcast over the channels
and the normalizers count each pixel once per channel. The Dice, BCE and
cross-entropy losses come with the multitask tasks.
"""

from __future__ import annotations

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements, in f32."""
    return torch.mean(torch.square(_f32(pred) - _f32(target)))


def roi_weighted_mse(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, roi_lambda: float = 10.0
) -> torch.Tensor:
    """Σ w·err² / (Σ w · C + 1e-8) with w = 1 + λ·mask (torch ``expand_as`` semantics)."""
    weights = 1.0 + roi_lambda * _f32(mask)  # (B, H, W, 1)
    sq_err = torch.square(_f32(pred) - _f32(target))  # (B, H, W, C)
    return torch.sum(weights * sq_err) / (torch.sum(weights) * pred.shape[-1] + 1e-8)


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Elementwise sqrt(diff² + eps²)."""
    diff = _f32(pred) - _f32(target)
    return torch.sqrt(diff * diff + eps * eps)


def roi_charbonnier(
    pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor, eps: float = 1e-3
) -> torch.Tensor:
    """Charbonnier penalty averaged over the ROI pixels (× channels)."""
    m = _f32(mask)
    return torch.sum(charbonnier(pred, target, eps) * m) / (torch.sum(m) * pred.shape[-1] + 1e-8)


__all__ = ["mse_loss", "roi_weighted_mse", "charbonnier", "roi_charbonnier"]

"""Losses of the port's task modules (counterpart of ``stain2stain_tpu/ops/losses.py``).

Only the plain CFM loss is ported so far (``losses.py:23-30``); the ROI,
Dice and cross-entropy losses come with the tasks that use them.
"""

from __future__ import annotations

import torch


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements, in f32."""
    return torch.mean(torch.square(pred.to(torch.float32) - target.to(torch.float32)))


__all__ = ["mse_loss"]

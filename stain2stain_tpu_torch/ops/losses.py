"""Losses of the port's task modules (counterpart of ``stain2stain_tpu/ops/losses.py``).

NHWC, all math in f32, global sums as the reference reduces them:

- plain CFM MSE (``losses.py:27-29``);
- ROI-upweighted MSE, w = 1 + λ·mask (``:32-46``);
- Charbonnier and its ROI mean (``:49-61``);
- binary Dice and BCE on logits (``:64-81``), multiclass Dice and softmax
  cross-entropy with ``ignore_index`` (``:84-123``), and the hard per-class
  Dice and IoU of the multitask eval (``:127-157``).

Masks are (B, H, W, 1) in [0, 1]; their weights broadcast over the channels
and the normalizers count each pixel once per channel. Class targets are
integer ids (B, H, W); a pixel equal to ``ignore_index`` is always left out
(JAX ``:95-99``: a planned departure from the reference, which masks only for
``ignore_index >= 0``). One-hot rows are comparisons against the class range,
so an id outside [0, C) is a zero row as in ``jax.nn.one_hot``; in the
cross-entropy such an id gives NaN, as JAX's ``take_along_axis`` fills it
(a negative id ≥ −C wraps around as a numpy index does), and never indexes
out of bounds on the device.
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


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Stable binary cross-entropy on logits, max(x, 0) − x·t + log1p(e^−|x|), mean-reduced."""
    logits, target = _f32(logits), _f32(target)
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits))))


def dice_loss(logits: torch.Tensor, target: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Binary Dice loss over the whole batch (global sums of sigmoid probabilities)."""
    probs = torch.sigmoid(_f32(logits)).reshape(-1)
    target = _f32(target).reshape(-1)
    dice = (2.0 * torch.sum(probs * target) + smooth) / (torch.sum(probs) + torch.sum(target) + smooth)
    return 1.0 - dice


def _one_hot(ids: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(…) integer ids → (…, C) f32; an id outside [0, C) gives a zero row."""
    return (ids[..., None] == torch.arange(num_classes, device=ids.device)).to(torch.float32)


def _valid_ids(target: torch.Tensor, ignore_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(valid pixels as bool (B, H, W), ids with the ignored pixels set to 0)."""
    tgt = target.to(torch.int64)
    valid = tgt != ignore_index
    return valid, torch.where(valid, tgt, torch.zeros_like(tgt))


def multiclass_dice_loss(
    logits: torch.Tensor, target: torch.Tensor, num_classes: int, smooth: float = 1.0, ignore_index: int = -100
) -> torch.Tensor:
    """1 − mean over classes of the Dice of softmax probabilities against the
    one-hot target, global sums per class; ``logits`` (B, H, W, C)."""
    valid, ids = _valid_ids(target, ignore_index)
    keep = valid[..., None].to(torch.float32)
    probs = torch.softmax(_f32(logits), dim=-1) * keep
    one_hot = _one_hot(ids, num_classes) * keep
    intersection = torch.sum(probs * one_hot, dim=(0, 1, 2))
    union = torch.sum(probs, dim=(0, 1, 2)) + torch.sum(one_hot, dim=(0, 1, 2))
    return 1.0 - torch.mean((2.0 * intersection + smooth) / (union + smooth))


def softmax_cross_entropy(logits: torch.Tensor, target: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Softmax cross-entropy, the mean over the valid pixels (at least 1)."""
    valid, ids = _valid_ids(target, ignore_index)
    num_classes = logits.shape[-1]
    ids = torch.where(ids < 0, ids + num_classes, ids)
    in_range = (ids >= 0) & (ids < num_classes)
    log_probs = torch.log_softmax(_f32(logits), dim=-1)
    nll = -torch.gather(log_probs, -1, ids.clamp(0, num_classes - 1)[..., None])[..., 0]
    nll = torch.where(in_range, nll, torch.full_like(nll, float("nan")))
    keep = valid.to(torch.float32)
    return torch.sum(nll * keep) / torch.clamp_min(torch.sum(keep), 1.0)


def per_class_dice_iou(
    logits: torch.Tensor, target: torch.Tensor, num_classes: int, ignore_index: int = -100, eps: float = 1e-7
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard-argmax Dice and IoU per class: two (C,) f32 tensors."""
    valid, ids = _valid_ids(target, ignore_index)
    keep = valid[..., None].to(torch.float32)
    pred_oh = _one_hot(torch.argmax(logits, dim=-1), num_classes) * keep
    tgt_oh = _one_hot(ids, num_classes) * keep
    intersection = torch.sum(pred_oh * tgt_oh, dim=(0, 1, 2))
    pred_sum, tgt_sum = torch.sum(pred_oh, dim=(0, 1, 2)), torch.sum(tgt_oh, dim=(0, 1, 2))
    dice = (2.0 * intersection + eps) / (pred_sum + tgt_sum + eps)
    iou = (intersection + eps) / (pred_sum + tgt_sum - intersection + eps)
    return dice, iou


__all__ = [
    "mse_loss",
    "roi_weighted_mse",
    "charbonnier",
    "roi_charbonnier",
    "bce_with_logits",
    "dice_loss",
    "multiclass_dice_loss",
    "softmax_cross_entropy",
    "per_class_dice_iou",
]

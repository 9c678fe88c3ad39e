"""Multitask multiclass flow matching and segmentation on a shared encoder
(counterpart of ``stain2stain_tpu/tasks/multitask_multiclass.py``).

The shared-backbone task of :mod:`.multitask` with a C-class segmentation
head: ``L_FM + α·(w·MulticlassDice + (1−w)·CE)``, pixels equal to
``ignore_index`` left out of both; in eval the hard per-class Dice and IoU,
averaged over the classes (``dice_coef``, ``iou``); ``generate`` returns
``(image, argmax ids (B, H, W) int64)``.
"""

from __future__ import annotations

import torch

from ..ops.losses import multiclass_dice_loss, per_class_dice_iou, softmax_cross_entropy
from .multitask import SharedBackboneTask


class MultitaskMulticlassFlowMatchingModule(SharedBackboneTask):
    batch_fields = ("image", "image", "class_mask")
    seg_metric_name = "seg_ce"

    def __init__(self, *args, num_classes: int = 2, ignore_index: int = -100, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_classes = num_classes
        self.ignore_index = ignore_index

    def _seg_terms(self, seg_logits, target):
        dice = multiclass_dice_loss(seg_logits, target, self.num_classes, ignore_index=self.ignore_index)
        return dice, softmax_cross_entropy(seg_logits, target, ignore_index=self.ignore_index)

    def _eval_metrics(self, seg_logits, target):
        dice, iou = per_class_dice_iou(seg_logits, target, self.num_classes, ignore_index=self.ignore_index)
        return {"dice_coef": torch.mean(dice), "iou": torch.mean(iou)}

    def predict_mask(self, seg_logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(seg_logits, dim=-1)


__all__ = ["MultitaskMulticlassFlowMatchingModule"]

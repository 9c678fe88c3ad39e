"""Mask-weighted ("masked") conditional flow matching (counterpart of
``stain2stain_tpu/tasks/conditional_flow_matching_masked.py``).

The batch is (source, target, binary mask); the velocity regression error
inside the mask is upweighted, w = 1 + λ·mask (λ = 10 by default) and
normalized by Σw (``:50-56``). ``aux_loss_weight`` is accepted for config
parity and unused, as in the reference. Inference is the plain ODE from the
source image.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.losses import roi_weighted_mse
from .conditional_flow_matching import ConditionalFlowMatchingModule


class MaskedFlowMatchingModule(ConditionalFlowMatchingModule):
    batch_fields = ("image", "image", "mask")

    def __init__(self, *args, roi_lambda: float = 10.0, aux_loss_weight: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.roi_lambda = roi_lambda
        self.aux_loss_weight = aux_loss_weight

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss"}) of one prepared (source, target, mask) batch; ``t``
        and the path noise ``eps`` may be injected."""
        src, tgt, mask = batch[0], batch[1], batch[2]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt = self._apply_net(t, xt, train=train, generator=generator)
        loss = roi_weighted_mse(vt, ut, mask, roi_lambda=self.roi_lambda)
        return loss, {"loss": loss.detach()}


__all__ = ["MaskedFlowMatchingModule"]

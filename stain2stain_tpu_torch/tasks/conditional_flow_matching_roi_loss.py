"""ROI-Charbonnier conditional flow matching (counterpart of
``stain2stain_tpu/tasks/conditional_flow_matching_roi_loss.py``).

loss = MSE(vt, ut) + λ_roi · Charbonnier(xt − x1) averaged over the ROI
pixels (ε = 1e-3). As in the reference, the Charbonnier term compares the
*interpolated point* xt with the target x1: it carries no parameter
gradient (xt is sampled, not predicted) and acts as a monitored term of the
logged loss. ``aux_loss_weight`` is accepted and unused. Inference is the
plain ODE.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.losses import mse_loss, roi_charbonnier
from .conditional_flow_matching import ConditionalFlowMatchingModule


class ROICharbonnierFlowMatchingModule(ConditionalFlowMatchingModule):
    batch_fields = ("image", "image", "mask")

    def __init__(
        self, *args, lambda_roi: float = 1.0, charb_eps: float = 1e-3, aux_loss_weight: float = 0.1, **kwargs
    ):
        super().__init__(*args, **kwargs)
        self.lambda_roi = lambda_roi
        self.charb_eps = charb_eps

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss", "flow_loss", "roi_charbonnier"}) of one prepared
        (source, target, mask) batch; ``t`` and ``eps`` may be injected."""
        src, tgt, mask = batch[0], batch[1], batch[2]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt = self._apply_net(t, xt, train=train, generator=generator)
        loss_fm = mse_loss(vt, ut)
        loss_roi = roi_charbonnier(xt, tgt, mask, eps=self.charb_eps)
        loss = loss_fm + self.lambda_roi * loss_roi
        return loss, {"loss": loss.detach(), "flow_loss": loss_fm.detach(), "roi_charbonnier": loss_roi.detach()}


__all__ = ["ROICharbonnierFlowMatchingModule"]

"""Mask-toggled conditional flow matching, classifier-free style
(counterpart of ``stain2stain_tpu/tasks/conditional_flow_matching_toggle_mask.py``).

As the mask-conditioned task, but each training step zeroes the whole
batch's mask with probability ``toggle_prob`` (one coin a step), so the
model learns conditioned and unconditioned generation. The coin is drawn
from the step's ``torch.Generator`` before ``t`` (JAX splits a key of its
own for it: another stream). ``generate(mask=None)`` runs on a zero mask,
the reference's unconditioned default; pass a mask to condition.
``coins`` counts the coins drawn and those that zeroed the mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.losses import mse_loss
from .conditional_flow_matching_conditional_mask import MaskConditionedFlowMatchingModule


class ToggleMaskFlowMatchingModule(MaskConditionedFlowMatchingModule):
    def __init__(self, *args, toggle_prob: float = 0.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.toggle_prob = toggle_prob
        self.coins = {"drawn": 0, "zeroed": 0}

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None, coin: Optional[bool] = None,
    ):
        """(loss, {"loss"}); ``t``, ``eps`` and the toggle's ``coin`` (True
        zeroes the mask) may be injected."""
        src, tgt, mask = batch[0], batch[1], batch[2]
        if train and self.toggle_prob > 0:
            if coin is None:
                gdev = generator.device if generator is not None else "cpu"
                coin = bool(torch.rand((), generator=generator, device=gdev) < self.toggle_prob)
            self.coins["drawn"] += 1
            if coin:
                self.coins["zeroed"] += 1
                mask = torch.zeros_like(mask)
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt = self._velocity(t, xt, mask, train=train, generator=generator)
        loss = mse_loss(vt, ut)
        return loss, {"loss": loss.detach()}

    def generate(
        self, source: torch.Tensor, num_steps: int = 100, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """As the conditioned task's; without a mask, on a zero mask."""
        if mask is None:
            source = torch.as_tensor(source, device=self.device).to(torch.float32)
            mask = torch.zeros((*source.shape[:-1], 1), dtype=torch.float32, device=self.device)
        return super().generate(source, num_steps=num_steps, mask=mask)


__all__ = ["ToggleMaskFlowMatchingModule"]

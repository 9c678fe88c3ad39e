"""Aux-fraction conditional flow matching (counterpart of
``stain2stain_tpu/tasks/conditional_flow_matching_aux_fraction.py``; the
reference deprecated it and no config names it).

- Flow loss: 0.5·mean(mask·err²) + 0.5·mean(err²).
- Auxiliary head ``frac_head``: the velocity field pooled over the pixels →
  Linear(C → 1) → sigmoid, regressing the mask's area fraction (the target
  carries no gradient); loss += ``aux_loss_weight`` · MSE(fraction).
- The head is one of the task's ``heads``: the optimizer trains it and the
  checkpoint saves it with the net. Its weight is drawn from N(0, 1/C)
  (torch's default generator), its bias 0, as JAX initializes it.
- Inference: the plain ODE on the velocity field alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .conditional_flow_matching import ConditionalFlowMatchingModule


class AuxFractionFlowMatchingModule(ConditionalFlowMatchingModule):
    batch_fields = ("image", "image", "mask")

    def __init__(self, *args, aux_loss_weight: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)
        self.aux_loss_weight = aux_loss_weight
        chans = int(self.net.out_channels)
        self.frac_head = nn.Linear(chans, 1, device=self.device)
        with torch.no_grad():
            self.frac_head.weight.normal_().div_(math.sqrt(chans))
            self.frac_head.bias.zero_()
        self.heads = {"frac_head": self.frac_head}

    def _forward(self, t, x, *, train: bool = False, generator: Optional[torch.Generator] = None):
        vt = self._apply_net(t, x, train=train, generator=generator)
        pooled = torch.mean(vt.to(torch.float32), dim=(1, 2))  # (B, C)
        return vt, torch.sigmoid(self.frac_head(pooled))[:, 0]

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss", "flow_loss", "aux_loss"}); ``t`` and ``eps`` may be injected."""
        src, tgt, mask = batch[0], batch[1], batch[2]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt, frac_pred = self._forward(t, xt, train=train, generator=generator)
        mask = mask.to(torch.float32)
        sq_err = torch.square(vt.to(torch.float32) - ut.to(torch.float32))
        flow_loss = 0.5 * torch.mean(mask * sq_err) + 0.5 * torch.mean(sq_err)
        frac_true = torch.mean(mask, dim=(1, 2, 3)).detach()
        aux_loss = torch.mean(torch.square(frac_pred - frac_true))
        loss = flow_loss + self.aux_loss_weight * aux_loss
        return loss, {"loss": loss.detach(), "flow_loss": flow_loss.detach(), "aux_loss": aux_loss.detach()}


__all__ = ["AuxFractionFlowMatchingModule"]

"""Mask-conditioned conditional flow matching, the mask as a fourth input
channel (counterpart of
``stain2stain_tpu/tasks/conditional_flow_matching_conditional_mask.py``).

The net (:class:`..models.UNet4to3`, or a ``UNetModel`` with ``dim[0] = 4``)
sees the RGB state and the mask concatenated on the channel axis at every
velocity evaluation; training is MSE(vt, ut). ``generate`` needs the mask:
this model never saw a zero mask, so generating without one raises
(``ValueError``, as JAX ``:60-70``); only the toggled variant substitutes a
zero mask. ``aux_loss_weight`` is accepted and unused.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.image import denormalize
from ..ops.losses import mse_loss
from .base import FlowMatchingTask


class MaskConditionedFlowMatchingModule(FlowMatchingTask):
    batch_fields = ("image", "image", "mask")

    def __init__(self, *args, aux_loss_weight: float = 0.1, **kwargs):
        super().__init__(*args, **kwargs)

    def _velocity(self, t, x, mask, *, train: bool = False, generator: Optional[torch.Generator] = None):
        return self._apply_net(t, torch.cat([x, mask.to(x.dtype)], dim=-1), train=train, generator=generator)

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss"}) of one prepared (source, target, mask) batch; ``t``
        and ``eps`` may be injected."""
        src, tgt, mask = batch[0], batch[1], batch[2]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt = self._velocity(t, xt, mask, train=train, generator=generator)
        loss = mse_loss(vt, ut)
        return loss, {"loss": loss.detach()}

    def generate(
        self, source: torch.Tensor, num_steps: int = 100, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, H, W, C) or (H, W, C) source in [-1, 1] and its (B, H, W, 1) or
        (H, W, 1) mask → translated (B, H, W, C) f32."""
        if mask is None:
            raise ValueError(
                "MaskConditionedFlowMatchingModule.generate requires the "
                "conditioning mask; only the mask-toggled variant supports "
                "unconditioned (zero-mask) generation"
            )
        with torch.inference_mode():
            source = torch.as_tensor(source, device=self.device).to(torch.float32)
            if source.ndim == 3:
                source = source[None]
            mask = torch.as_tensor(mask, device=self.device).to(torch.float32)
            if mask.ndim == 3:
                mask = mask[None]

            def velocity(t, x, mask):
                return self._velocity(t.expand(x.shape[0]), x, mask)

            return self._integrate(velocity, source, num_steps, mask)

    def render_panels(self, batch: tuple, generator: Optional[torch.Generator] = None, num_steps: int = 2) -> dict:
        """Source / generated / target panels in [0, 1] and the conditioning mask."""
        src, tgt, mask = self.prepare_batch(self.device_fields(batch), generator, train=False)[:3]
        n = min(self.n_images_log, src.shape[0])
        gen = self.generate(src[:n], num_steps=num_steps, mask=mask[:n])
        panels = {"source": denormalize(src[:n]), "generated": denormalize(gen), "target": denormalize(tgt[:n]),
                  "mask": mask[:n]}
        return {name: x.cpu().numpy() for name, x in panels.items()}


__all__ = ["MaskConditionedFlowMatchingModule"]

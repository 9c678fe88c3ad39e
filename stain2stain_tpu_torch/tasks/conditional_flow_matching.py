"""Plain conditional-flow-matching stain translation task.

Counterpart of ``stain2stain_tpu/tasks/conditional_flow_matching.py``: per
training step, sample (t, xt, ut) on the straight-line path between the
paired source and target tiles and regress the velocity net with
MSE(vt, ut) (``:32-38``); ``generate`` integrates the learned velocity ODE
from the source image at t=0 to the target stain at t=1 (``:40-47``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.losses import mse_loss
from .base import FlowMatchingTask


class ConditionalFlowMatchingModule(FlowMatchingTask):
    batch_fields = ("image", "image", "meta", "meta")

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss"}) of one prepared (source, target) batch; ``t`` may be
        injected (the tests hand both packages the same draws)."""
        src, tgt = batch[0], batch[1]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(src, tgt, generator=generator, t=t)
        vt = self._apply_net(t, xt, train=train, generator=generator)
        loss = mse_loss(vt, ut)
        return loss, {"loss": loss.detach()}

    def generate(self, source: torch.Tensor, num_steps: int = 100) -> torch.Tensor:
        """(B, H, W, C) or (H, W, C) source in [-1, 1] → translated (B, H, W, C) f32."""
        with torch.inference_mode():
            source = torch.as_tensor(source, device=self.device).to(torch.float32)
            if source.ndim == 3:
                source = source[None]

            def velocity(t, x):
                return self._apply_net(t.expand(x.shape[0]), x, train=False)

            return self._integrate(velocity, source, num_steps)


__all__ = ["ConditionalFlowMatchingModule"]

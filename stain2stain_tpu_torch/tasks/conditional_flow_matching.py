"""Plain conditional-flow-matching stain translation task (sampling).

Counterpart of ``stain2stain_tpu/tasks/conditional_flow_matching.py:40-47``:
``generate`` integrates the learned velocity ODE from the source image at
t=0 to the target stain at t=1.
"""

from __future__ import annotations

import torch

from .base import FlowMatchingTask


class ConditionalFlowMatchingModule(FlowMatchingTask):
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

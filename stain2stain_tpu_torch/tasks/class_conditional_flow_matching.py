"""Class-conditional (any↔any) flow-matching stain translation.

Counterpart of ``stain2stain_tpu/tasks/class_conditional_flow_matching.py``:
the velocity net takes a target-stain class id ``y`` beside (t, x); training
regresses MSE(vt, ut) under the label of the *target* domain (``:45-51``);
``generate`` integrates the ODE with the requested class injected at every
step (``:53-64``); ``generate_all_classes`` tiles the batch across the class
axis so every target domain integrates in one solver run (``:66-81``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..ops.image import denormalize
from ..ops.losses import mse_loss
from .base import FlowMatchingTask


class ClassConditionalFlowMatchingModule(FlowMatchingTask):
    batch_fields = ("image", "image", "label")

    def __init__(self, *args, num_classes: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_classes = num_classes

    def loss_and_metrics(
        self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """(loss, {"loss"}) of one prepared (source, target, label) batch, under
        the target domain's label; ``t`` and the path noise ``eps`` may be
        injected (the tests hand both packages the same draws)."""
        src, tgt, y = batch[0], batch[1], batch[2]
        t, xt, ut = self.flow_matcher.sample_location_and_conditional_flow(
            src, tgt, generator=generator, t=t, eps=eps
        )
        vt = self._apply_net(t, xt, train=train, y=y, generator=generator)
        loss = mse_loss(vt, ut)
        return loss, {"loss": loss.detach()}

    def _generate(self, source: torch.Tensor, y: torch.Tensor, num_steps: int) -> torch.Tensor:
        def velocity(t, x, y):
            return self._apply_net(t.expand(x.shape[0]), x, train=False, y=y)

        return self._integrate(velocity, source, num_steps, y)

    @staticmethod
    def _source(source, device) -> torch.Tensor:
        source = torch.as_tensor(source, device=device).to(torch.float32)
        return source[None] if source.ndim == 3 else source

    def generate(
        self, source: torch.Tensor, num_steps: int = 100, target_class: Union[int, torch.Tensor] = 0
    ) -> torch.Tensor:
        """(B, H, W, C) or (H, W, C) source in [-1, 1] → (B, H, W, C) f32
        translated to ``target_class`` (one int, or one per example)."""
        with torch.inference_mode():
            source = self._source(source, self.device)
            y = torch.as_tensor(target_class, dtype=torch.int64, device=self.device)
            return self._generate(source, y.expand(source.shape[0]), num_steps)

    def generate_all_classes(self, source: torch.Tensor, num_steps: int = 100) -> torch.Tensor:
        """Every target class in one solver run: (num_classes, B, H, W, C).

        The batch is tiled across the class axis, so the velocity net runs on
        num_classes·B tiles at each evaluation."""
        with torch.inference_mode():
            source = self._source(source, self.device)
            n_cls, batch = self.num_classes, source.shape[0]
            tiled = source.repeat(n_cls, 1, 1, 1)
            y = torch.arange(n_cls, dtype=torch.int64, device=self.device).repeat_interleave(batch)
            return self._generate(tiled, y, num_steps).reshape(n_cls, batch, *source.shape[1:])

    def render_panels(self, batch: tuple, generator: Optional[torch.Generator] = None, num_steps: int = 2) -> dict:
        """Panels generated with each example's own target class (JAX ``:83-96``):
        with class 0 for all, the panel would show the wrong stain beside
        another class's target."""
        src, tgt, y = self.prepare_batch(self.device_fields(batch), generator, train=False)
        n = min(self.n_images_log, src.shape[0])
        gen = self.generate(src[:n], num_steps=num_steps, target_class=y[:n])
        return {name: denormalize(x).cpu().numpy() for name, x in
                (("source", src[:n]), ("generated", gen), ("target", tgt[:n]))}


__all__ = ["ClassConditionalFlowMatchingModule"]

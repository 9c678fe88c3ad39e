"""Task-module base (counterpart of ``stain2stain_tpu/tasks/base.py``).

A task bundles the velocity net with its path sampler, loss recipe, ODE
solver and optimizer configuration:

- ``prepare_batch(batch, generator, train, augment)`` — host or device
  fields → device tensors: uint8 RGB → float32 [-1, 1], masks → float32
  (B, H, W, 1), and in training the *shared* random crop and flips over the
  images and masks (``base.py:60-107``);
- ``loss_and_metrics(batch, generator, train)`` → (loss, metrics);
- ``configure_optimizers()`` → (optimizer over ``trainable_parameters()``:
  the net's, then those of the task's own ``heads``, scheduler);
- ``render_panels(batch, generator, num_steps)`` — source / generated /
  target previews in [0, 1] for the image logger;
- ``generate`` (subclasses) integrates the learned velocity ODE.

The training-time randomness comes from the ``torch.Generator`` the trainer
passes (seeded from (seed, step)).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.cfm import ConditionalFlowMatcher
from ..ops.image import normalize_uint8, paired_random_crop_flip
from ..ops.solvers import SolverConfig, VelocityFn


class FlowMatchingTask:
    """Shared machinery for CFM variants.

    ``batch_fields`` names each field of a loader batch: ``"image"`` (uint8
    RGB (B, H, W, 3) → [-1, 1]), ``"mask"`` (uint8 or float (B, H, W) or
    (B, H, W, 1) → float32 (B, H, W, 1)), ``"label"`` (int class ids → int64
    on the task's device) or ``"meta"`` (host-only, e.g. filenames).
    ``device``: where the net runs; ``None`` keeps the device the net's
    parameters already lie on (the UNet resolves its own, CUDA by default).

    ``heads``: modules with trained parameters that the task holds beside
    the net (the aux-fraction head); the optimizer and the checkpoint take
    them with the net.
    """

    batch_fields: Sequence[str] = ("image", "image")
    monitor: str = "val/loss"

    def __init__(
        self,
        net: nn.Module,
        flow_matcher: Optional[ConditionalFlowMatcher] = None,
        solver: Optional[SolverConfig] = None,
        optimizer=None,
        scheduler=None,
        compile: bool = True,  # config parity; the port runs eagerly
        log_images: bool = True,
        n_images_log: int = 5,
        device: DeviceLike = None,
    ):
        if device is None:
            device = next(net.parameters()).device
        self.device = resolve_device(device)
        self.net = net.to(self.device)
        self.flow_matcher = flow_matcher or ConditionalFlowMatcher(sigma=0.0)
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.log_images = log_images
        self.n_images_log = n_images_log
        if solver is not None and callable(solver) and not isinstance(solver, SolverConfig):
            solver = solver()  # _partial_ config parity
        self.solver = solver or SolverConfig(solver="euler")
        self.heads: dict[str, nn.Module] = {}

    def to(self, device: DeviceLike) -> "FlowMatchingTask":
        self.device = resolve_device(device)
        self.net.to(self.device)
        for head in self.heads.values():
            head.to(self.device)
        return self

    def trainable_parameters(self) -> list[nn.Parameter]:
        """Every trained parameter: the net's, then each head's in name order."""
        params = list(self.net.parameters())
        for name in sorted(self.heads):
            params.extend(self.heads[name].parameters())
        return params

    # ------------------------------------------------------------ batch prep
    def device_fields(self, batch: tuple) -> tuple:
        """The batch without its host-only fields (filenames)."""
        return tuple(x for x, kind in zip(batch, self.batch_fields) if kind != "meta")

    def prepare_batch(
        self,
        batch: tuple,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        augment: Optional[dict] = None,
    ) -> tuple:
        """Device tensors of a batch's fields; with ``train`` and ``augment``
        one crop and flip shared across the image and mask fields (applied
        before the conversion: the same pixels either way)."""
        kinds = [k for k in self.batch_fields if k != "meta"][: len(batch)]
        if "class_mask" in kinds:
            raise NotImplementedError("'class_mask' batch fields come with the multitask tasks, not ported yet")
        unknown = [kind for kind in kinds if kind not in ("image", "mask", "label")]
        if unknown:
            raise NotImplementedError(f"batch field kinds {unknown} are not ported")
        arrays = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(self.device) for x in batch]
        for i, kind in enumerate(kinds):
            if kind == "mask" and arrays[i].ndim == 3:
                arrays[i] = arrays[i][..., None]
        spatial = [i for i, kind in enumerate(kinds) if kind in ("image", "mask")]
        if train and augment and spatial:
            cropped = paired_random_crop_flip(
                [arrays[i] for i in spatial],
                crop_size=augment["crop_size"],
                hflip=augment.get("hflip", True),
                vflip=augment.get("vflip", True),
                generator=generator,
            )
            for i, x in zip(spatial, cropped):
                arrays[i] = x
        return tuple(
            x.to(torch.int64) if kind == "label"
            else x.to(torch.float32) if kind == "mask" or x.dtype != torch.uint8
            else normalize_uint8(x)
            for x, kind in zip(arrays, kinds)
        )

    # ----------------------------------------------------------------- model
    def loss_and_metrics(self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False):
        """Returns (loss, metrics dict)."""
        raise NotImplementedError

    def _apply_net(self, t: torch.Tensor, x: torch.Tensor, *, train: bool = False, **kw) -> torch.Tensor:
        self.net.train(train)
        return self.net(t, x, **kw)

    def _integrate(self, velocity_fn: VelocityFn, x0: torch.Tensor, num_steps: int) -> torch.Tensor:
        return self.solver(velocity_fn, x0, num_steps)

    # ------------------------------------------------------------- optimizers
    def configure_optimizers(self):
        """Returns (optimizer over :meth:`trainable_parameters`, host scheduler or None)."""
        if self.optimizer is None:
            raise ValueError("the task has no optimizer (set model.optimizer in the config)")
        opt = self.optimizer(self.trainable_parameters()) if callable(self.optimizer) else self.optimizer
        sched = self.scheduler() if callable(self.scheduler) else self.scheduler
        return opt, sched

    # --------------------------------------------------- qualitative logging
    def render_panels(self, batch: tuple, generator: Optional[torch.Generator] = None, num_steps: int = 2) -> dict:
        """Source / generated / target [0, 1] numpy panels for the image logger."""
        src, tgt = self.prepare_batch(self.device_fields(batch), generator, train=False)[:2]
        n = min(self.n_images_log, src.shape[0])
        gen = self.generate(src[:n], num_steps=num_steps)

        def to01(x):
            return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0).cpu().numpy()

        return {"source": to01(src[:n]), "generated": to01(gen), "target": to01(tgt[:n])}


__all__ = ["FlowMatchingTask"]

"""Task-module base (counterpart of ``stain2stain_tpu/tasks/base.py``).

:class:`TaskModule` is what the trainer needs of a task: a net on a device
with its optimizer configuration and the batch recipe —

- ``prepare_batch(batch, generator, train, augment)`` — host or device
  fields → device tensors: uint8 RGB → float32 [-1, 1], masks → float32
  (B, H, W, 1), class masks → int64 ids (B, H, W), labels → int64, raw
  fields unchanged, and in training the *shared* random crop and flips
  over the images, masks and class masks (``base.py:60-107``);
- ``loss_and_metrics(batch, generator, train)`` → (loss, metrics);
- ``configure_optimizers()`` → (optimizer over ``trainable_parameters()``:
  the net's, then those of the task's own ``heads``, scheduler).

:class:`FlowMatchingTask` adds what the CFM tasks share: the path sampler,
the ODE solver, ``render_panels(batch, generator, num_steps)`` (source /
generated / target previews in [0, 1] for the image logger) and, in
subclasses, ``generate``, which integrates the learned velocity ODE.

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


class TaskModule:
    """A net on a device, its optimizer configuration and its batch recipe.

    ``batch_fields`` names each field of a loader batch: ``"image"`` (uint8
    RGB (B, H, W, 3) → [-1, 1]), ``"mask"`` (uint8 or float (B, H, W) or
    (B, H, W, 1) → float32 (B, H, W, 1)), ``"class_mask"`` (integer class
    ids (B, H, W) or (B, H, W, 1) → int64 (B, H, W)), ``"label"`` (int class
    ids → int64 on the task's device), ``"raw"`` (moved to the device
    unchanged, for the task to convert) or ``"meta"`` (host-only, e.g.
    filenames).
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
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.log_images = log_images
        self.n_images_log = n_images_log
        self.heads: dict[str, nn.Module] = {}

    def to(self, device: DeviceLike) -> "TaskModule":
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
        one crop and flip shared across the image, mask and class-mask fields
        (applied before the conversion: the same pixels either way; the class
        masks last in the group, as JAX orders it, and never through floats)."""
        kinds = [k for k in self.batch_fields if k != "meta"][: len(batch)]
        unknown = [kind for kind in kinds if kind not in ("image", "mask", "class_mask", "label", "raw")]
        if unknown:
            raise NotImplementedError(f"batch field kinds {unknown} are not ported")
        arrays = [torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(self.device) for x in batch]
        for i, kind in enumerate(kinds):
            if kind == "mask" and arrays[i].ndim == 3:
                arrays[i] = arrays[i][..., None]
            elif kind == "class_mask" and arrays[i].ndim == 4:
                arrays[i] = arrays[i][..., 0]
        spatial = [i for i, kind in enumerate(kinds) if kind in ("image", "mask")]
        spatial += [i for i, kind in enumerate(kinds) if kind == "class_mask"]
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
            x if kind == "raw"
            else x.to(torch.int64) if kind in ("label", "class_mask")
            else x.to(torch.float32) if kind == "mask" or x.dtype != torch.uint8
            else normalize_uint8(x)
            for x, kind in zip(arrays, kinds)
        )

    # ----------------------------------------------------------------- model
    def loss_and_metrics(self, batch: tuple, generator: Optional[torch.Generator] = None, train: bool = False):
        """Returns (loss, metrics dict)."""
        raise NotImplementedError

    # ------------------------------------------------------------- optimizers
    def configure_optimizers(self):
        """Returns (optimizer over :meth:`trainable_parameters`, host scheduler or None)."""
        if self.optimizer is None:
            raise ValueError("the task has no optimizer (set model.optimizer in the config)")
        opt = self.optimizer(self.trainable_parameters()) if callable(self.optimizer) else self.optimizer
        sched = self.scheduler() if callable(self.scheduler) else self.scheduler
        return opt, sched


class FlowMatchingTask(TaskModule):
    """Shared machinery for CFM variants: the path sampler and the ODE solver
    beside :class:`TaskModule`'s net, and the previews of ``generate``."""

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
        super().__init__(net, optimizer=optimizer, scheduler=scheduler, log_images=log_images,
                         n_images_log=n_images_log, device=device)
        self.flow_matcher = flow_matcher or ConditionalFlowMatcher(sigma=0.0)
        if solver is not None and callable(solver) and not isinstance(solver, SolverConfig):
            solver = solver()  # _partial_ config parity
        self.solver = solver or SolverConfig(solver="euler")

    def _apply_net(self, t: torch.Tensor, x: torch.Tensor, *, train: bool = False, **kw) -> torch.Tensor:
        self.net.train(train)
        return self.net(t, x, **kw)

    def _integrate(self, velocity_fn: VelocityFn, x0: torch.Tensor, num_steps: int, *args) -> torch.Tensor:
        """Solve from ``x0`` with ``velocity_fn(t, x, *args)``; the tensors it
        reads come in ``args`` and the net's state is declared to the solver,
        so the dopri5 loop exports (``ops/solvers.py``)."""
        return self.solver(velocity_fn, x0, num_steps, args=args, modules=(self.net,))

    # --------------------------------------------------- qualitative logging
    def render_panels(self, batch: tuple, generator: Optional[torch.Generator] = None, num_steps: int = 2) -> dict:
        """Source / generated / target [0, 1] numpy panels for the image logger."""
        src, tgt = self.prepare_batch(self.device_fields(batch), generator, train=False)[:2]
        n = min(self.n_images_log, src.shape[0])
        gen = self.generate(src[:n], num_steps=num_steps)

        def to01(x):
            return torch.clamp((x + 1.0) * 0.5, 0.0, 1.0).cpu().numpy()

        return {"source": to01(src[:n]), "generated": to01(gen), "target": to01(tgt[:n])}


__all__ = ["TaskModule", "FlowMatchingTask"]

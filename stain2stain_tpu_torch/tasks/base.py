"""Task-module base (counterpart of ``stain2stain_tpu/tasks/base.py:149-181``).

A task bundles the velocity net with its ODE solver. This slice of the port
serves: it holds ``net`` and ``solver`` and integrates. The training-only
arguments (``flow_matcher``, ``optimizer``, ``scheduler``) are accepted, so
the model configs instantiate unchanged, and stored unused until training is
ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.solvers import SolverConfig, VelocityFn


class FlowMatchingTask:
    """Shared machinery for CFM variants: the net, the solver and ``_integrate``.

    ``device``: where the net runs; ``None`` keeps the device the net's
    parameters already lie on (the UNet resolves its own, CUDA by default).
    """

    def __init__(
        self,
        net: nn.Module,
        flow_matcher=None,
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
        self.flow_matcher = flow_matcher
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.log_images = log_images
        self.n_images_log = n_images_log
        if solver is not None and callable(solver) and not isinstance(solver, SolverConfig):
            solver = solver()  # _partial_ config parity
        self.solver = solver or SolverConfig(solver="euler")

    def _apply_net(self, t: torch.Tensor, x: torch.Tensor, *, train: bool = False, **kw) -> torch.Tensor:
        self.net.train(train)
        return self.net(t, x, **kw)

    def _integrate(self, velocity_fn: VelocityFn, x0: torch.Tensor, num_steps: int) -> torch.Tensor:
        return self.solver(velocity_fn, x0, num_steps)


__all__ = ["FlowMatchingTask"]

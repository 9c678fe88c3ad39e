"""Optimizer and scheduler factories (counterpart of ``stain2stain_tpu/training/optim.py``).

The configs name these as ``_partial_`` factories
(``configs/model/conditional_flow_matching.yaml:4-14``); the task calls the
optimizer factory with the net's parameters. The JAX package builds optax
chains; the same update rules are ``torch.optim`` classes here:

- :class:`Adam` — L2 weight decay added into the gradient before the moment
  update (optax ``add_decayed_weights`` → ``scale_by_adam``), which is what
  ``torch.optim.Adam``'s ``weight_decay`` does.
- :class:`AdamW` — decoupled decay (``optax.adamw``).
- :class:`SGD` — decay into the gradient, then ``optax.trace`` momentum.

:class:`ReduceLROnPlateau` is the host-side controller the trainer steps once
per validated epoch; :func:`set_learning_rate` / :func:`get_learning_rate`
read and write the optimizer's learning rate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch


class Adam(torch.optim.Adam):
    """``Adam(params, lr, weight_decay, betas, eps, flatten)``, the JAX package's
    signature. ``flatten`` selects the JAX package's one-vector update dispatch
    and has no effect here."""

    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 0.0,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8, flatten: bool = True):
        super().__init__(params, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        self.flatten = flatten


class AdamW(torch.optim.AdamW):
    def __init__(self, params, lr: float = 1e-4, weight_decay: float = 0.01,
                 betas: tuple = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)


class SGD(torch.optim.SGD):
    def __init__(self, params, lr: float = 1e-2, momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


@dataclass
class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau-equivalent host controller.

    Call :meth:`step` once per validated epoch with the monitored metric and
    the base learning rate; it returns a new absolute learning rate when it
    should change, else None. Serializable for checkpoint resume.
    """

    mode: str = "min"
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    min_lr: float = 0.0
    cooldown: int = 0

    best: float = field(default=math.inf)
    num_bad_epochs: int = 0
    cooldown_counter: int = 0
    current_factor: float = 1.0

    def __post_init__(self):
        if self.mode == "max" and self.best == math.inf:
            self.best = -math.inf

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            margin = self.best * (1 - self.threshold) if self.threshold_mode == "rel" else self.best - self.threshold
            return metric < margin
        margin = self.best * (1 + self.threshold) if self.threshold_mode == "rel" else self.best + self.threshold
        return metric > margin

    def step(self, metric: float, base_lr: float) -> Optional[float]:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
            new_factor = self.current_factor * self.factor
            new_lr = max(base_lr * new_factor, self.min_lr)
            if new_lr < base_lr * self.current_factor - 1e-12:
                self.current_factor = new_factor
                return new_lr
        return None

    def state_dict(self) -> dict:
        return {
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
            "cooldown_counter": self.cooldown_counter,
            "current_factor": self.current_factor,
        }

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


__all__ = ["Adam", "AdamW", "SGD", "ReduceLROnPlateau", "set_learning_rate", "get_learning_rate"]

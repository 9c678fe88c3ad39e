"""Train state and checkpoint I/O (counterpart of ``stain2stain_tpu/training/state.py``).

A checkpoint is a directory: ``<path>/state.pt`` (``torch.save`` of the step
counter, the model's and the optimizer's state dicts) and ``<path>/meta.json``
with the JAX package's keys (epoch, global_step, callback_metrics, scheduler,
base_lr, callbacks, rng), so resume is exact. Loading uses
``weights_only=True``: a file holding arbitrary pickled objects is refused.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
from torch import nn


@dataclass
class TrainState:
    step: int
    net: nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.net.state_dict(), "optimizer": self.optimizer.state_dict()}


class CheckpointIO:
    """Checkpoint directories of :class:`TrainState` plus host-side meta."""

    def save(self, path: str | Path, state: TrainState, meta: dict) -> None:
        path = Path(path).absolute()
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / "state.pt.tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path / "state.pt")  # a reader never sees a partial file
        (path / "meta.json").write_text(json.dumps(_jsonable(meta), indent=2))

    def restore(self, path: str | Path, state: TrainState, weights_only: bool = False) -> dict:
        """Load the checkpoint into ``state`` (the model only with
        ``weights_only``); returns its meta."""
        path = Path(path).absolute()
        if not (path / "state.pt").exists():
            raise FileNotFoundError(f"No checkpoint at {path}")
        device = next(state.net.parameters()).device
        saved = torch.load(path / "state.pt", map_location=device, weights_only=True)
        state.net.load_state_dict(saved["model"])
        if not weights_only:
            state.optimizer.load_state_dict(saved["optimizer"])
            state.step = int(saved["step"])
        meta_file = path / "meta.json"
        return json.loads(meta_file.read_text()) if meta_file.exists() else {}


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    return obj


__all__ = ["TrainState", "CheckpointIO"]

"""Train state and checkpoint I/O (counterpart of ``stain2stain_tpu/training/state.py``).

A checkpoint is a directory: ``<path>/state.pt`` (``torch.save`` of the step
counter, the model's and the optimizer's state dicts, and ``heads``, the
state dicts of the task's own trained modules, only when it has any, so a
file written before heads existed loads unchanged) and ``<path>/meta.json``
with the JAX package's keys (epoch, global_step, callback_metrics, scheduler,
base_lr, callbacks, rng), so resume is exact. Loading uses
``weights_only=True``: a file holding arbitrary pickled objects is refused.

With several processes every rank calls :meth:`CheckpointIO.save`: the state
dict is gathered whole (the sharded optimizer's moments, a collective), rank
0 alone writes, and every rank waits at a host barrier until the files are
there (JAX ``state.py:59-91``). :meth:`CheckpointIO.restore` loads on every
rank. The files hold whole tensors only, so a checkpoint of ``fsdp=2`` on two
ranks resumes in one process and the other way round.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import torch
from torch import nn

from ..parallel.distributed import host_barrier, process_index


@dataclass
class TrainState:
    step: int
    net: nn.Module
    optimizer: torch.optim.Optimizer
    heads: dict = field(default_factory=dict)  # name -> nn.Module held by the task

    def state_dict(self) -> dict:
        state = {"step": self.step, "model": self.net.state_dict(), "optimizer": self.optimizer.state_dict()}
        if self.heads:
            state["heads"] = {name: head.state_dict() for name, head in self.heads.items()}
        return state


class CheckpointIO:
    """Checkpoint directories of :class:`TrainState` plus host-side meta."""

    def save(self, path: str | Path, state: TrainState, meta: dict) -> None:
        path = Path(path).absolute()
        whole = state.state_dict()  # collective under a sharded optimizer: every rank calls save
        if process_index() == 0:
            path.mkdir(parents=True, exist_ok=True)
            tmp = path / "state.pt.tmp"
            torch.save(whole, tmp)
            os.replace(tmp, path / "state.pt")  # a reader never sees a partial file
            (path / "meta.json").write_text(json.dumps(_jsonable(meta), indent=2))
        host_barrier("checkpoint_save")

    def restore(self, path: str | Path, state: TrainState, weights_only: bool = False) -> dict:
        """Load the checkpoint into ``state`` (the model only with
        ``weights_only``); returns its meta."""
        path = Path(path).absolute()
        if not (path / "state.pt").exists():
            raise FileNotFoundError(f"No checkpoint at {path}")
        device = next(state.net.parameters()).device
        saved = torch.load(path / "state.pt", map_location=device, weights_only=True)
        state.net.load_state_dict(saved["model"])
        load_heads(state.heads, saved, path)
        if not weights_only:
            state.optimizer.load_state_dict(saved["optimizer"])
            state.step = int(saved["step"])
        meta_file = path / "meta.json"
        return json.loads(meta_file.read_text()) if meta_file.exists() else {}


def load_heads(heads: dict, saved: dict, path: Any) -> None:
    """Load ``saved["heads"]`` into ``heads`` (name → module), strictly: a
    head the file lacks, or one the task lacks, raises."""
    stored = saved.get("heads", {})
    if set(stored) != set(heads):
        raise KeyError(f"{path}: the checkpoint holds heads {sorted(stored)}, the task {sorted(heads)}")
    for name, head in heads.items():
        head.load_state_dict(stored[name])


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    return obj


__all__ = ["TrainState", "CheckpointIO", "load_heads"]

"""Serving: a sealed generator program (counterpart of ``stain2stain_tpu/serving.py``).

- :func:`export_generator` — ``torch.export`` of ``task.generate`` for a fixed
  (batch, H, W) with the weights baked in, the ODE sampler inside (the fixed
  steps unrolled, dopri5 as one ``while_loop`` node), written with
  ``torch.export.save`` (``.pt2``) beside a JSON sidecar with the JAX
  package's keys;
- :func:`load_generator` — ``torch.export.load`` of that file; returns
  ``call(source) -> image``. It needs no model code, only the port's kernel
  ops registered: the program calls ``s2s::attention_fwd`` (K1-fwd) and, for
  a bf16 ``fused_conv`` net, ``s2s::conv3x3_fwd`` (K2), which importing
  :mod:`.ops.attention` and :mod:`.ops.conv` registers. On the card those ops
  launch the kernels, and a program that cannot launch them raises.

The program's signature is ``generate(source) -> image`` (``(image, mask)``
for the multitask tasks); conditional variants bake their condition in
through ``gen_kwargs`` (``target_class=2``, or ``mask=`` a tensor, kept as a
constant of the program).

Differences from the JAX package: the task holds its weights, so there is no
``variables`` argument; a program runs on the one device type it was traced
on (``platforms`` names at most one, "cuda" or "cpu").
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from ._device import DeviceLike, resolve_device
from .utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


class _Generator(nn.Module):
    """``task.generate`` as a module whose parameters are the task's, so the
    export lifts them into the program."""

    def __init__(self, task, num_steps: int, gen_kwargs: dict):
        super().__init__()
        self.net = task.net
        self.task = [task]  # a list: the task is no module and holds the net already registered
        self.num_steps = num_steps
        self.gen_kwargs = gen_kwargs

    def forward(self, source: torch.Tensor):
        return self.task[0].generate(source, num_steps=self.num_steps, **self.gen_kwargs)


def _platform(platforms: Optional[Sequence[str]], device: DeviceLike) -> torch.device:
    if platforms is None:
        return resolve_device(device)
    names = sorted({_PLATFORMS.get(str(p).lower(), str(p)) for p in platforms})
    if len(names) != 1 or names[0] not in ("cuda", "cpu"):
        raise ValueError(f"a sealed generator runs on one device type, cuda or cpu; got platforms {list(platforms)}")
    dev = resolve_device(device if device is not None else names[0])
    if dev.type != names[0]:
        raise ValueError(f"device {dev} does not match platforms {list(platforms)}")
    return dev


def export_generator(
    task,
    out_path: str | Path,
    batch: int,
    image_size: int,
    num_steps: int = 50,
    in_channels: int = 3,
    device: DeviceLike = None,
    platforms: Optional[Sequence[str]] = None,
    **gen_kwargs,
) -> Path:
    """Seal ``task.generate`` into ``out_path`` (a ``.pt2`` program) with its
    weights baked in, and write ``<out_path>.json``.

    ``device``: where the program runs (None → the task's own device, or the
    one ``platforms`` names); the task is moved there.
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    dev = _platform(platforms, device) if (platforms is not None or device is not None) else task.device
    task.to(dev)
    example = torch.zeros((batch, image_size, image_size, in_channels), dtype=torch.float32, device=dev)
    program = torch.export.export(_Generator(task, num_steps, gen_kwargs), (example,), strict=False)
    torch.export.save(program, out_path)
    meta = {
        "task": type(task).__name__,
        "batch": batch,
        "image_size": image_size,
        "num_steps": num_steps,
        "in_channels": in_channels,
        "platforms": [dev.type],
        "gen_kwargs": {k: str(v) for k, v in gen_kwargs.items()},
    }
    Path(str(out_path) + ".json").write_text(json.dumps(meta, indent=2))
    log.info(f"Exported sealed generator to {out_path} ({out_path.stat().st_size / 1e6:.1f} MB)")
    return out_path


def load_generator(path: str | Path, device: DeviceLike = None) -> Callable:
    """Load a sealed generator; returns ``call(source) -> image`` (its
    ``program`` attribute: the loaded ``torch.export.ExportedProgram``).

    ``device``: None → the platform the sidecar names (the CUDA card for a
    card's program, which raises without one); a device of another type raises.
    """
    from .ops import attention, conv  # noqa: F401  (registers s2s::attention_fwd and s2s::conv3x3_fwd)

    path = Path(path)
    sidecar = Path(str(path) + ".json")
    platform = json.loads(sidecar.read_text())["platforms"][0] if sidecar.is_file() else None
    dev = resolve_device(device if device is not None else platform)
    if platform is not None and dev.type != platform:
        raise ValueError(f"{path} was exported for {platform}, not {dev.type}")
    program = torch.export.load(path)
    module = program.module()

    def call(source):
        with torch.no_grad():
            return module(torch.as_tensor(source, dtype=torch.float32, device=dev))

    call.program = program
    return call


__all__ = ["export_generator", "load_generator"]

"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the CUDA card; anything else is taken as asked.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present: the port never carries on on the CPU by itself. Tests and other
    CPU callers pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def runs_plain(name: str, *tensors: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes its plain version: True when every tensor
    lies on the CPU, False when all lie on CUDA devices (launch the kernel);
    raises for any other device or a mix."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {[str(t.device) for t in tensors]}")
    return False


__all__ = ["resolve_device", "runs_plain", "DeviceLike"]

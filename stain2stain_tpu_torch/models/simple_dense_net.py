"""Template MLP of the MNIST demo (counterpart of
``stain2stain_tpu/models/simple_dense_net.py:17-33``).

Flatten, three ``Linear → LayerNorm → ReLU`` blocks, a linear head. The
LayerNorm is flax's: ε 1e-6, computed in f32 whatever the compute dtype,
and the logits come out f32. ``dtype`` is the compute dtype of the linear
layers (the trainer sets bf16 under bf16 precision; the parameters stay
f32). State-dict keys follow the flax module names: ``dense_{i}``,
``norm_{i}``, ``head``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from .unet import _as_dtype


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class SimpleDenseNet(nn.Module):
    def __init__(
        self,
        input_size: int = 784,
        lin1_size: int = 64,
        lin2_size: int = 128,
        lin3_size: int = 64,
        output_size: int = 10,
        dtype: Any = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype = _as_dtype(dtype)
        widths = (input_size, lin1_size, lin2_size, lin3_size)
        for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"dense_{i}", nn.Linear(n_in, n_out, device=device))
            self.add_module(f"norm_{i}", nn.LayerNorm(n_out, eps=1e-6, device=device))
        self.head = nn.Linear(lin3_size, output_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, ...) input (flattened) → (B, output_size) f32 logits."""
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for i in range(3):
            x = _linear(getattr(self, f"dense_{i}"), x)
            x = F.relu(getattr(self, f"norm_{i}")(x.float()).to(self.dtype))
        return _linear(self.head, x).float()


__all__ = ["SimpleDenseNet"]

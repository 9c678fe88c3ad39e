"""Shared UNet encoder of the multitask family (counterpart of
``stain2stain_tpu/models/shared_encoder.py``).

``SharedEncoder``: ``DoubleConv`` (3×3 conv → norm → ReLU, twice) at
``features[0]``, then per further width a 2×2 stride-2 max pool and a
``DoubleConv``; it returns ``(bottleneck, skips)`` with the skips
deepest-first and without the bottleneck. ``TimeEmbedding`` is the flow
decoder's sinusoidal embedding (``[sin ‖ cos]``).

Norms follow flax's defaults, not torch's (``Norm2d``, JAX ``:27-42``):

- ``norm="group"`` (the default; no config overrides it): ``nn.GroupNorm``
  with the group count of JAX ``models/unet.py::_gn_groups`` and flax's
  ε = 1e-6 (torch and ADM use 1e-5). torch takes the variance as
  E[(x − E[x])²] where flax takes E[x²] − E[x]²; the two agree to f32
  rounding at these activations.
- ``norm="batch"`` (the reference's checkpoints): :class:`BatchNorm2d`, flax
  ``nn.BatchNorm`` semantics in a ``nn.BatchNorm2d``'s parameters and
  buffers: ε 1e-5, running statistics updated as
  ``0.99 · running + 0.01 · batch`` (flax momentum 0.99 is torch 0.01) with
  the **biased** batch variance (torch uses the unbiased one), in training
  mode; evaluation normalizes with the running statistics.

Layout: the image enters NHWC (B, H, W, C) as in the port's ``UNetModel``;
the feature maps between the encoder and the decoders are NCHW. ``dtype`` is
the compute type of the convs; each norm runs and returns at least f32
(f64 in a float64 net), and the ReLU output is cast back to ``dtype`` (JAX
``DoubleConv``). State-dict keys are the reference's:
``inc.double_conv.{0,1,3,4}`` and
``downs.{i}.maxpool_conv.1.double_conv.{0,1,3,4}``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.time_embedding import timestep_embedding_sincos
from .unet import _as_dtype, _conv, _gn_groups

GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm's default
BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm's default
BATCH_NORM_MOMENTUM = 0.99  # flax's: running = momentum · running + (1 − momentum) · batch


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` parameters and buffers with flax ``nn.BatchNorm``'s
    update: in training mode the output is normalized with the batch's
    statistics (biased variance, as torch does) and the running mean and
    variance move by 1 − 0.99 toward the batch's mean and **biased**
    variance; ``num_batches_tracked`` counts the updates."""

    def __init__(self, num_features: int, device: DeviceLike = None):
        super().__init__(num_features, eps=BATCH_NORM_EPS, momentum=1.0 - BATCH_NORM_MOMENTUM, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(BATCH_NORM_MOMENTUM).add_(mean, alpha=1.0 - BATCH_NORM_MOMENTUM)
            self.running_var.mul_(BATCH_NORM_MOMENTUM).add_(var, alpha=1.0 - BATCH_NORM_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def norm2d(norm: str, channels: int, device: DeviceLike = None) -> nn.Module:
    """The norm of a ``DoubleConv``: ``"group"`` or ``"batch"`` (JAX ``Norm2d``)."""
    if norm == "group":
        return nn.GroupNorm(_gn_groups(channels), channels, eps=GROUP_NORM_EPS, device=device)
    if norm == "batch":
        return BatchNorm2d(channels, device=device)
    raise ValueError(f"norm must be 'group' or 'batch', got {norm!r}")


class DoubleConv(nn.Module):
    """(3×3 conv → norm → ReLU) × 2 on NCHW, in the reference's
    ``double_conv`` Sequential layout (conv 0, norm 1, conv 3, norm 4)."""

    def __init__(self, in_channels: int, out_channels: int, norm: str = "group", device: DeviceLike = None):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device),
            norm2d(norm, out_channels, device),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, device=device),
            norm2d(norm, out_channels, device),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        norm_dtype = torch.promote_types(dtype, torch.float32)
        for conv, norm in ((0, 1), (3, 4)):
            x = _conv(self.double_conv[conv], x, dtype)
            x = F.relu(self.double_conv[norm](x.to(norm_dtype)), inplace=True).to(dtype)
        return x


class Down(nn.Module):
    """2×2 max pool, then ``DoubleConv`` (reference key ``maxpool_conv.1``)."""

    def __init__(self, in_channels: int, out_channels: int, norm: str = "group", device: DeviceLike = None):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_channels, out_channels, norm, device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.maxpool_conv[1](F.max_pool2d(x, 2), dtype)


class SharedEncoder(nn.Module):
    """UNet encoder: NHWC image → (NCHW bottleneck, [NCHW skips deepest-first])."""

    def __init__(
        self,
        in_channels: int = 3,
        features: Sequence[int] = (64, 128, 256, 512, 1024),
        return_skip_connections: bool = True,
        norm: str = "group",
        dtype: Any = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.features = tuple(features)
        self.return_skip_connections = return_skip_connections
        self.norm = norm
        self.dtype = _as_dtype(dtype)
        self.inc = DoubleConv(in_channels, self.features[0], norm, device)
        self.downs = nn.ModuleList(
            Down(c_in, c_out, norm, device) for c_in, c_out in zip(self.features[:-1], self.features[1:])
        )

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        skips = [self.inc(x, self.dtype)]
        for down in self.downs:
            skips.append(down(skips[-1], self.dtype))
        if self.return_skip_connections:
            return skips[-1], skips[:-1][::-1]
        return skips[-1], []


class TimeEmbedding(nn.Module):
    """(B,) or (B, 1) timesteps → (B, dim) f32, ``[sin ‖ cos]``."""

    def __init__(self, dim: int = 256):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        if t.ndim == 2:
            t = t[:, 0]
        return timestep_embedding_sincos(t, self.dim)


__all__ = ["SharedEncoder", "DoubleConv", "Down", "BatchNorm2d", "norm2d", "TimeEmbedding"]

"""The two decoder heads of the multitask family (counterpart of
``stain2stain_tpu/models/task_decoders.py``).

Both walk the UNet up path: bilinear ×2 with ``align_corners=True`` → concat
``[skip, x]`` → ``DoubleConv``, then a 1×1 out conv.

- ``FlowMatchingDecoder``: the velocity head. The time embedding goes
  through Linear → SiLU → Linear → a projection to the bottleneck's
  channels and is **added** per channel to the bottleneck.
- ``SegmentationDecoder``: the mask head (1 logit channel for a binary mask,
  C for C classes).

JAX builds the corner-aligned upsample from two 1-D lerps (``:29-52``, with
an ``in_len == 1`` branch that repeats the pixel);
``F.interpolate(mode="bilinear", align_corners=True)`` computes the same
function, the one-pixel case included. The decoders take the encoder's NCHW
feature maps and return NHWC f32 (B, H, W, out_channels). State-dict keys
are the reference's: ``ups.{i}.conv.double_conv.*``, ``time_mlp.{0,2}``,
``time_proj``, ``outc``. Only the bilinear up path exists, as in the JAX
package (the reference's ``bilinear=False`` transposed convs are refused).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from .shared_encoder import DoubleConv
from .unet import _as_dtype, _conv


def upsample_bilinear(x: torch.Tensor) -> torch.Tensor:
    """NCHW ×2 bilinear with corner-aligned sampling (torch ``align_corners=True``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class Up(nn.Module):
    """Upsample ×2, concat ``[skip, x]``, ``DoubleConv`` (reference key ``conv``)."""

    def __init__(self, in_channels: int, out_channels: int, norm: str = "group", device: DeviceLike = None):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, norm, device)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = upsample_bilinear(x).to(dtype)
        return self.conv(torch.cat([skip.to(dtype), x], dim=1), dtype)


def _check_bilinear(bilinear: bool) -> None:
    if not bilinear:
        raise NotImplementedError("only the bilinear up path is ported (bilinear=True), as in the JAX package")


class _Decoder(nn.Module):
    """The up path shared by both heads: ``Up(in + feat → feat)`` per width, then a 1×1 conv."""

    def __init__(self, bottleneck_channels, features, out_channels, norm, dtype, device):
        super().__init__()
        device = resolve_device(device)
        self.bottleneck_channels = bottleneck_channels
        self.features = tuple(features)
        self.out_channels = out_channels
        self.norm = norm
        self.dtype = _as_dtype(dtype)
        widths = (bottleneck_channels,) + self.features
        self.ups = nn.ModuleList(Up(c_in + feat, feat, norm, device) for c_in, feat in zip(widths[:-1], widths[1:]))
        self.outc = nn.Conv2d(self.features[-1], out_channels, 1, device=device)

    def _decode(self, x: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        for up, skip in zip(self.ups, skips):
            x = up(x, skip, self.dtype)
        return _conv(self.outc, x, self.dtype).to(torch.float32).permute(0, 2, 3, 1)


class FlowMatchingDecoder(_Decoder):
    """Velocity head: (bottleneck, skips, t_emb (B, time_emb_dim)) → (B, H, W, out_channels)."""

    def __init__(
        self,
        bottleneck_channels: int = 1024,
        features: Sequence[int] = (512, 256, 128, 64),
        out_channels: int = 3,
        time_emb_dim: int = 256,
        bilinear: bool = True,
        norm: str = "group",
        dtype: Any = torch.float32,
        device: DeviceLike = None,
    ):
        _check_bilinear(bilinear)
        super().__init__(bottleneck_channels, features, out_channels, norm, dtype, device)
        device = resolve_device(device)
        self.time_emb_dim = time_emb_dim
        self.time_mlp = nn.Sequential(
            nn.Linear(time_emb_dim, time_emb_dim, device=device),
            nn.SiLU(),
            nn.Linear(time_emb_dim, time_emb_dim, device=device),
        )
        self.time_proj = nn.Linear(time_emb_dim, bottleneck_channels, device=device)

    def forward(self, bottleneck: torch.Tensor, skips: Sequence[torch.Tensor], t_emb: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        t = _conv(self.time_mlp[0], t_emb, dtype)
        t = _conv(self.time_mlp[2], F.silu(t), dtype)
        t = _conv(self.time_proj, t, dtype)
        return self._decode(bottleneck.to(dtype) + t[:, :, None, None], skips)


class SegmentationDecoder(_Decoder):
    """Mask head: (bottleneck, skips) → logits (B, H, W, out_channels)."""

    def __init__(
        self,
        bottleneck_channels: int = 1024,
        features: Sequence[int] = (512, 256, 128, 64),
        out_channels: int = 1,
        bilinear: bool = True,
        norm: str = "group",
        dtype: Any = torch.float32,
        device: DeviceLike = None,
    ):
        _check_bilinear(bilinear)
        super().__init__(bottleneck_channels, features, out_channels, norm, dtype, device)

    def forward(self, bottleneck: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._decode(bottleneck.to(self.dtype), skips)


__all__ = ["FlowMatchingDecoder", "SegmentationDecoder", "Up", "upsample_bilinear"]

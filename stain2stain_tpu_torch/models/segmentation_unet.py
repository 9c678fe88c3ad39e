"""Standalone segmentation UNet (counterpart of ``stain2stain_tpu/models/segmentation_unet.py``).

No config names it; it completes the multitask family's components. Per
width of ``features`` a ``DoubleConv`` then a 2×2 max pool, a
``DoubleConv`` bottleneck at ``features[-1]``, and four ``Up`` blocks whose
widths are the bilinear halving of JAX ``:37-40``: ``features[k] // 2`` for
the deeper widths, reversed, then ``features[0]``; a 1×1 out conv. NHWC
image in, NHWC f32 logits out. State-dict keys follow the JAX module
names: ``encs.{i}``, ``bottleneck``, ``decs.{i}.conv``, ``outc``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from .shared_encoder import DoubleConv
from .task_decoders import Up
from .unet import _as_dtype, _conv


class SegmentationUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 1,
        features: Sequence[int] = (64, 128, 256, 512),
        norm: str = "group",
        dtype: Any = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.features = tuple(features)
        self.out_channels = out_channels
        self.dtype = _as_dtype(dtype)
        widths = (in_channels,) + self.features
        self.encs = nn.ModuleList(DoubleConv(c_in, c_out, norm, device) for c_in, c_out in zip(widths[:-1], widths[1:]))
        self.bottleneck = DoubleConv(self.features[-1], self.features[-1], norm, device)
        dec_feats = [f // 2 for f in reversed(self.features[1:])] + [self.features[0]]
        self.decs = nn.ModuleList()
        ch = self.features[-1]
        for feat, skip_ch in zip(dec_feats, reversed(self.features)):
            self.decs.append(Up(ch + skip_ch, feat, norm, device))
            ch = feat
        self.outc = nn.Conv2d(ch, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype
        x = x.to(dtype).permute(0, 3, 1, 2).contiguous()
        skips = []
        for enc in self.encs:
            x = enc(x, dtype)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottleneck(x, dtype)
        for dec, skip in zip(self.decs, reversed(skips)):
            x = dec(x, skip, dtype)
        return _conv(self.outc, x, dtype).to(torch.float32).permute(0, 2, 3, 1)


__all__ = ["SegmentationUNet"]

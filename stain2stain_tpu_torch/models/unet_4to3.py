"""RGB + mask → RGB velocity net of the mask-conditioned tasks (counterpart
of ``stain2stain_tpu/models/unet_4to3.py``).

A thin wrapper around :class:`UNetModel` with ``in_channels=4`` and
``out_channels=3``; the task concatenates the mask on the channel axis. Its
``attention_resolutions`` default ``(16, 8)`` are raw downsample rates (so
ds 8, level 3 of the flagship's four, attends), not the ``"16,8"`` string of
feature sizes. The inner net is ``unet``, so the state-dict keys are
``unet.<UNetModel key>`` as in the reference wrapper.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from .._device import DeviceLike
from .unet import UNetModel


class UNet4to3(nn.Module):
    def __init__(
        self,
        image_size: int = 256,
        num_channels: int = 128,
        num_res_blocks: int = 2,
        channel_mult: Sequence[int] = (1, 2, 2, 4),
        attention_resolutions: Any = (16, 8),
        dropout: float = 0.0,
        num_heads: int = 4,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        dtype: Any = torch.float32,
        device: DeviceLike = None,
        **unet_kwargs: Any,
    ):
        super().__init__()
        self.unet = UNetModel(
            dim=(4, image_size, image_size),
            num_channels=num_channels,
            num_res_blocks=num_res_blocks,
            channel_mult=channel_mult,
            attention_resolutions=attention_resolutions,
            dropout=dropout,
            num_heads=num_heads,
            num_head_channels=num_head_channels,
            use_scale_shift_norm=use_scale_shift_norm,
            out_channels=3,
            dtype=dtype,
            device=device,
            **unet_kwargs,
        )
        self.out_channels = 3

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.dtype

    @dtype.setter
    def dtype(self, value: torch.dtype) -> None:  # the trainer's bf16-mixed sets it
        self.unet.dtype = value

    def forward(self, t: torch.Tensor, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        """t: () or (B,); x: (B, H, W, 4) NHWC → (B, H, W, 3) f32."""
        return self.unet(t, x, **kwargs)


__all__ = ["UNet4to3"]

"""A small patch-transformer velocity net on the program's side, for the test
that adds an architecture by files alone: the program's calling convention
(``forward(t, x, y=None, generator=None)`` on NHWC tiles, built with
``device``), the parameter names of the plain reference that the test writes
into its throwaway tree, no dropout. A configuration brings it in with
``model.net={_target_: benchmark.tests.patch_transformer.PatchTransformer, ...}``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class PatchTransformer(nn.Module):
    """Patch embedding, a sinusoidal time embedding added to every token, one
    pre-norm transformer block (attention, then a tanh-GELU MLP) and a linear
    unpatchify."""

    def __init__(self, dim=(3, 32, 32), patch: int = 8, width: int = 32, heads: int = 2, device=None):
        super().__init__()
        channels = int(dim[0])
        self.patch, self.width, self.heads = int(patch), int(width), int(heads)
        self.embed = nn.Conv2d(channels, width, patch, stride=patch)
        self.time = nn.Linear(width, width)
        self.norm1 = nn.LayerNorm(width)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(nn.Linear(width, 2 * width), nn.GELU(approximate="tanh"),
                                 nn.Linear(2 * width, width))
        self.out_norm = nn.LayerNorm(width)
        self.out = nn.Linear(width, patch * patch * channels)
        self.to(device)

    def forward(self, t, x: torch.Tensor, y=None, generator=None) -> torch.Tensor:
        """t: () or (B,); x: (B, H, W, C) → the velocity (B, H, W, C)."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        b, h, w, c = x.shape
        p, gh, gw = self.patch, h // self.patch, w // self.patch
        patches = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4).reshape(b, gh * gw, c * p * p)
        tokens = patches @ self.embed.weight.reshape(self.width, -1).T + self.embed.bias
        half = self.width // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=x.device) / half)
        angles = t[:, None] * freqs[None]
        tokens = tokens + self.time(torch.cat([torch.cos(angles), torch.sin(angles)], dim=-1))[:, None]
        q, k, v = self.qkv(self.norm1(tokens)).reshape(b, gh * gw, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        attended = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, gh * gw, self.width)
        tokens = tokens + self.proj(attended)
        tokens = tokens + self.mlp(self.norm2(tokens))
        out = self.out(self.out_norm(tokens)).reshape(b, gh, gw, p, p, c)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)

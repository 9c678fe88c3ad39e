"""The plain reference of the ADM UNet velocity net, in plain PyTorch.

The published guided-diffusion architecture (Dhariwal & Nichol 2021,
https://arxiv.org/abs/2105.05233) as torchcfm packages it: its state-dict
keys, its legacy qkv row order (``[h0·(q,k,v), h1·(q,k,v), …]``), GroupNorm
with eps 1e-5, FiLM conditioning (``use_scale_shift_norm``). Written from
the published design, not from the measured program, and importing none of
it. Two additions the measured recipes need, both from
:mod:`benchmark.reference.common`:

- dropout in each ResBlock as the program's counter hash of the NCHW
  element index (``dropout_keep``), so a train step can be followed exactly
  from the seeds the step draws; ``batch_offset`` gives a block of rows its
  place in the whole batch;
- ``cast``: a rounding of the operands of every convolution, dense layer
  and attention product, forward and backward, so the same net computes in
  a lower precision (bfloat16 or float8 products, float32 sums) for the
  control.

Inputs and outputs are NCHW f32. Everything runs in float32; on the card the
caller turns TF32 off.

The module meets the interface of a configuration's ``reference``
(``benchmark/README.md``): :func:`build`, the net's ``dropout_layers``,
:func:`attention_shapes`, :func:`fused_convs` and :func:`zeroed`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.common import Ctx, conv, dropout_keep, timestep_embedding


def gn_groups(channels: int) -> int:
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb_ch: int, out_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(nn.GroupNorm(gn_groups(ch), ch), nn.SiLU(),
                                       nn.Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, 2 * out_ch))
        self.out_layers = nn.Sequential(nn.GroupNorm(gn_groups(out_ch), out_ch), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = nn.Conv2d(ch, out_ch, 1) if ch != out_ch else nn.Identity()
        self.slot = 0

    def forward(self, x, emb, ctx: Ctx):
        h = conv(self.in_layers[2], F.silu(self.in_layers[0](x)), ctx)
        scale, shift = torch.chunk(conv(self.emb_layers[1], F.silu(emb), ctx)[:, :, None, None], 2, dim=1)
        h = F.silu(self.out_layers[0](h) * (1 + scale) + shift)
        if ctx.seeds is not None and ctx.rate > 0:
            keep = dropout_keep(ctx.seeds[self.slot], h.shape, ctx.rate, ctx.batch_offset, h.device)
            h = h * keep.to(h.dtype) * (1.0 / (1.0 - ctx.rate))
        h = conv(self.out_layers[3], h, ctx)
        skip = conv(self.skip_connection, x, ctx) if isinstance(self.skip_connection, nn.Conv2d) else x
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = nn.GroupNorm(gn_groups(ch), ch)
        self.qkv = nn.Conv1d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv1d(ch, ch, 1)

    def forward(self, x, ctx: Ctx):
        b, c, height, width = x.shape
        flat = x.reshape(b, c, height * width)
        r = ctx.cast
        qkv = r.out(F.conv1d(r.inp(self.norm(flat)), r.inp(self.qkv.weight), self.qkv.bias))
        d = c // self.num_heads
        q, k, v = qkv.reshape(b * self.num_heads, 3 * d, height * width).split(d, dim=1)
        logits = r.out(torch.einsum("bct,bcs->bts", r.inp(q), r.inp(k))) / math.sqrt(d)
        a = r.out(torch.einsum("bts,bcs->bct", r.inp(torch.softmax(logits, dim=-1)), r.inp(v)))
        out = r.out(F.conv1d(r.inp(a.reshape(b, c, height * width)), r.inp(self.proj_out.weight), self.proj_out.bias))
        return (flat + out).reshape(b, c, height, width)


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x, ctx: Ctx):
        return conv(self.op, x, ctx)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x, ctx: Ctx):
        return conv(self.conv, F.interpolate(x, scale_factor=2, mode="nearest"), ctx)


class ADMUNet(nn.Module):
    """``forward(t, x, ctx)``: t (B,), x (B, C, H, W) → the velocity (B, C_out, H, W).

    ``attention_levels``: the downsample ratios that attend (the config's
    "16,8" feature sizes at its image size); the middle block always attends."""

    def __init__(self, in_channels: int, num_channels: int, num_res_blocks: int, channel_mult, attention_levels,
                 num_head_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        mc, emb_ch = num_channels, 4 * num_channels
        self.num_channels = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb_ch), nn.SiLU(), nn.Linear(emb_ch, emb_ch))
        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(in_channels, mc, 3, padding=1)])])
        ch, ds, skips, levels = mc, 1, [mc], []
        for level, mult in enumerate(channel_mult):
            out_ch = mult * mc
            heads = max(out_ch // num_head_channels, 1) if ds in attention_levels else 0
            levels.append((level, out_ch, heads))
            for _ in range(num_res_blocks):
                mods = [ResBlock(ch, emb_ch, out_ch)]
                ch = out_ch
                if heads:
                    mods.append(AttentionBlock(ch, heads))
                self.input_blocks.append(nn.ModuleList(mods))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                skips.append(ch)
                ds *= 2
        mid_heads = max(ch // num_head_channels, 1)
        self.middle_block = nn.ModuleList([ResBlock(ch, emb_ch, ch), AttentionBlock(ch, mid_heads),
                                           ResBlock(ch, emb_ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, out_ch, heads in reversed(levels):
            for i in range(num_res_blocks + 1):
                mods = [ResBlock(ch + skips.pop(), emb_ch, out_ch)]
                ch = out_ch
                if heads:
                    mods.append(AttentionBlock(ch, heads))
                if i == num_res_blocks and level != 0:
                    mods.append(Upsample(ch))
                self.output_blocks.append(nn.ModuleList(mods))
        self.out = nn.Sequential(nn.GroupNorm(gn_groups(ch), ch), nn.SiLU(),
                                 nn.Conv2d(ch, out_channels or in_channels, 3, padding=1))
        self.dropout_layers = [m for m in self.modules() if isinstance(m, ResBlock)]
        for i, block in enumerate(self.dropout_layers):
            block.slot = i

    def forward(self, t: torch.Tensor, x: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        ctx = ctx or Ctx()
        emb = timestep_embedding(t, self.num_channels)
        emb = conv(self.time_embed[2], F.silu(conv(self.time_embed[0], emb, ctx)), ctx)

        def run(mods, h):
            for m in mods:
                if isinstance(m, ResBlock):
                    h = m(h, emb, ctx)
                elif isinstance(m, nn.Conv2d):
                    h = conv(m, h, ctx)
                else:
                    h = m(h, ctx)
            return h

        h, hs = x, []
        for block in self.input_blocks:
            h = run(block, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for block in self.output_blocks:
            h = run(block, torch.cat([h, hs.pop()], dim=1))
        return conv(self.out[2], F.silu(self.out[0](h)), ctx)


def attention_levels(attention_resolutions, image_size: int) -> tuple:
    """The downsample ratios that attend: of a "16,8" string, the feature-map
    sizes at the configured image size; a list gives the ratios themselves."""
    if isinstance(attention_resolutions, str):
        return tuple(image_size // int(r) for r in attention_resolutions.split(",") if r.strip())
    return tuple(int(r) for r in attention_resolutions)


def build(net_cfg: dict, device=None) -> ADMUNet:
    """The reference net of a configuration's ``net`` block, in f32 on ``device``."""
    image_size = int(net_cfg["dim"][-1])
    with torch.device(device or "cpu"):
        return ADMUNet(
            in_channels=int(net_cfg["dim"][0]), num_channels=int(net_cfg["num_channels"]),
            num_res_blocks=int(net_cfg["num_res_blocks"]), channel_mult=tuple(net_cfg["channel_mult"]),
            attention_levels=attention_levels(net_cfg["attention_resolutions"], image_size),
            num_head_channels=int(net_cfg["num_head_channels"]), out_channels=net_cfg.get("out_channels"),
        )


def attention_shapes(net_cfg: dict, size: int) -> list[tuple[int, int, int]]:
    """(heads, T, d) of every attention layer of one forward on one tile of
    ``size`` × ``size`` pixels (which levels attend follows the net's
    configured image size, as the net reads its configuration)."""
    levels = attention_levels(net_cfg["attention_resolutions"], int(net_cfg["dim"][-1]))
    mult, mc, per_head = list(net_cfg["channel_mult"]), int(net_cfg["num_channels"]), int(net_cfg["num_head_channels"])
    out, ds = [], 1
    for level, m in enumerate(mult):
        ch = m * mc
        if ds in levels:
            t = (size // ds) ** 2
            down = int(net_cfg["num_res_blocks"])
            up = int(net_cfg["num_res_blocks"]) + 1
            out += [(max(ch // per_head, 1), t, per_head if ch >= per_head else ch)] * (down + up)
        if level != len(mult) - 1:
            ds *= 2
    ch = mult[-1] * mc
    out.append((max(ch // per_head, 1), (size // ds) ** 2, per_head if ch >= per_head else ch))
    return out


def fused_convs(net_cfg: dict, size: int) -> list[tuple[int, int, int]]:
    """(side, C, D) of the two 3×3 convolutions of every ResBlock of one
    forward on a tile of ``size`` px, in forward order: the input conv C → D,
    the output conv D → D (the convolutions the program's fused path runs
    through K2-K5)."""
    mc, nrb = int(net_cfg["num_channels"]), int(net_cfg["num_res_blocks"])
    mult = list(net_cfg["channel_mult"])
    convs, skips, ch, side = [], [mc], mc, size

    def block(c, d, s):
        convs.extend([(s, c, d), (s, d, d)])

    for level, m in enumerate(mult):
        for _ in range(nrb):
            block(ch, m * mc, side)
            ch = m * mc
            skips.append(ch)
        if level != len(mult) - 1:
            skips.append(ch)
            side //= 2
    block(ch, ch, side)
    block(ch, ch, side)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(nrb + 1):
            block(ch + skips.pop(), m * mc, side)
            ch = m * mc
        if level != 0:
            side *= 2
    return convs


def zeroed(name: str) -> bool:
    """Whether the recipe initializes parameter ``name`` at zero: each
    ResBlock's last conv, each attention output and the output conv."""
    return name.startswith("out.2.") or ".out_layers.3." in name or ".proj_out." in name

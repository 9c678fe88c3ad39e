"""The plain reference of the velocity net: an ADM UNet in plain PyTorch.

The published guided-diffusion architecture (Dhariwal & Nichol 2021,
https://arxiv.org/abs/2105.05233) as torchcfm packages it: its state-dict
keys, its legacy qkv row order (``[h0·(q,k,v), h1·(q,k,v), …]``), GroupNorm
with eps 1e-5, FiLM conditioning (``use_scale_shift_norm``). Written from
the published design, not from the measured program, and importing none of
it. Two additions the measured recipes need:

- dropout in each ResBlock as a counter hash of the NCHW element index
  (murmur3's finalizer of ``((b·H + h)·W + w)·C + c + seed``, kept where it
  lies below ``(1 - rate)·2^32``), so a train step can be followed exactly
  from the seeds the step draws; ``batch_offset`` gives a block of rows its
  place in the whole batch;
- ``cast``: a rounding of the operands of every convolution, dense layer
  and attention product, forward and backward, so the same net computes in
  a lower precision (bfloat16 or float8 products, float32 sums) for the
  control.

Inputs and outputs are NCHW f32. Everything runs in float32; on the card the
caller turns TF32 off.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

class _RoundGrad(torch.autograd.Function):
    """The identity forward; the backward rounds the gradient with ``fn``."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Cast:
    """A precision for every product of the net: ``inp`` rounds a product's
    inputs (its gradient passes unrounded, straight through), ``out`` rounds
    the gradient that reaches a product's output, so the backward's products
    take rounded operands too. Sums stay float32."""

    def __init__(self, fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.fn = fn

    def inp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.fn is None else x + (self.fn(x) - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.fn is None or not y.requires_grad else _RoundGrad.apply(y, self.fn)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale a tensor, its largest magnitude at 448, as float8 training scales."""
    scale = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


def rounding(precision: str) -> Cast:
    """The :class:`Cast` of ``float32`` (none), ``bfloat16`` or ``float8``
    (e4m3, scaled a tensor at a time)."""
    fns = {"float32": None, "bfloat16": _bf16, "float8": _fp8}
    if precision not in fns:
        raise ValueError(f"unknown precision {precision!r}")
    return Cast(fns[precision])


def gn_groups(channels: int) -> int:
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values mod 2^32 as int32 tensors with the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _i32(value: int) -> int:
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def dropout_keep(seed: int, shape, rate: float, batch_offset: int, device) -> torch.Tensor:
    """The keep mask (bool) of an NCHW ``shape`` whose first row is row ``batch_offset`` of the batch."""
    b, c, h, w = shape
    bc = (torch.arange(b, dtype=torch.int64).reshape(b, 1, 1, 1) + batch_offset) * (h * w * c) + torch.arange(
        c, dtype=torch.int64).reshape(1, c, 1, 1)
    hw = (torch.arange(h, dtype=torch.int64).reshape(1, 1, h, 1) * w
          + torch.arange(w, dtype=torch.int64).reshape(1, 1, 1, w)) * c
    x = _wrap32(bc + seed).to(device) + _wrap32(hw).to(device)
    x ^= (x >> 16) & 0xFFFF
    x *= _i32(0x85EBCA6B)
    x ^= (x >> 13) & 0x7FFFF
    x *= _i32(0xC2B2AE35)
    x ^= (x >> 16) & 0xFFFF
    threshold = min(2**32 - 1, round((1.0 - rate) * 2**32))
    return (x ^ torch.iinfo(torch.int32).min) < threshold - 2**31


class Ctx:
    """What one forward needs besides its inputs: the rounding, the dropout
    rate, this block of rows' offset and the seed of each ResBlock (None: eval)."""

    def __init__(self, cast: Optional[Cast] = None, rate: float = 0.0, seeds: Optional[list] = None,
                 batch_offset: int = 0):
        self.cast, self.rate, self.seeds, self.batch_offset = cast or Cast(), rate, seeds, batch_offset


def conv(m: nn.Module, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    c = ctx.cast
    if isinstance(m, nn.Linear):
        return c.out(F.linear(c.inp(x), c.inp(m.weight), m.bias))
    return c.out(F.conv2d(c.inp(x), c.inp(m.weight), m.bias, stride=m.stride, padding=m.padding))


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
        self.resblocks = [m for m in self.modules() if isinstance(m, ResBlock)]
        for i, block in enumerate(self.resblocks):
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

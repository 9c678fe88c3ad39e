"""What every plain reference net shares, whatever its architecture: the
rounding of its products (:class:`Cast`, :func:`rounding`), the context of
one forward (:class:`Ctx`), a product through that rounding (:func:`conv`),
the sinusoidal time embedding and the hash dropout mask that the program
draws. A reference net (``configs/<name>.json``'s ``reference``) imports
these by their absolute name, ``benchmark.reference.common``, and no other
reference file.

Everything here is plain PyTorch in float32; on the card the caller turns
TF32 off.
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
    """The keep mask (bool) of an NCHW ``shape`` whose first row is row
    ``batch_offset`` of the batch: murmur3's finalizer of
    ``((b·H + h)·W + w)·C + c + seed``, kept where it lies below
    ``(1 - rate)·2^32``, so a train step can be followed exactly from the
    seeds the step draws."""
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
    rate, this block of rows' offset and the seed of each of the net's
    ``dropout_layers`` (None: eval, or a net with no dropout)."""

    def __init__(self, cast: Optional[Cast] = None, rate: float = 0.0, seeds: Optional[list] = None,
                 batch_offset: int = 0):
        self.cast, self.rate, self.seeds, self.batch_offset = cast or Cast(), rate, seeds, batch_offset


def conv(m: nn.Module, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``m`` (a dense layer or a 2-D convolution) applied to ``x``, its
    operands rounded by ``ctx``'s cast."""
    c = ctx.cast
    if isinstance(m, nn.Linear):
        return c.out(F.linear(c.inp(x), c.inp(m.weight), m.bias))
    return c.out(F.conv2d(c.inp(x), c.inp(m.weight), m.bias, stride=m.stride, padding=m.padding))

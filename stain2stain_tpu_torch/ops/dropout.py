"""Storage-free dropout for the UNet (counterpart of ``stain2stain_tpu/ops/dropout.py``).

:func:`hash_dropout` is ``x * mask / (1 - rate)`` whose keep mask is the
murmur3 finalizer of (logical element index + seed), compared against an
integer threshold (``dropout.py:79-106``). The mask is a pure function of one
uint32 seed, so the ``torch.autograd.Function`` saves only that seed and the
backward regenerates the identical mask: no residual bytes.

Bit-exact with JAX: JAX hashes the **NHWC** element index; the port's UNet
runs NCHW, so the index is computed from (b, c, h, w) as
``((b·H + h)·W + w)·C + c``. torch lacks most ``uint32`` ops, so the hash runs
in int32 with wrapping multiplies, logical shifts written as an arithmetic
shift plus a mask, and the unsigned compare as a signed one on values with
the top bit flipped.

:class:`FastDropout` (impl ``"hash"``) replaces ``nn.Dropout`` in the UNet.
It has no parameters, so state-dict keys do not change. Its seed, one per
layer per call, is drawn from the ``torch.Generator`` the caller passes (the
trainer seeds one from (seed, step)); tests inject it.

:func:`hardware_dropout` (impl ``"bits"``, JAX ``dropout.py:47-76``) keeps the
elements whose 16-bit random word lies below JAX's integer threshold
``min(2^16 - 1, round((1 - rate) · 2^16))``. The words come from a
``torch.Generator`` on the tensor's device seeded with the layer's uint32
seed, so its backward, too, regenerates the mask from the seed alone. torch's
generator is not JAX's PRNG: the masks differ from JAX's draws (the keep
probability and the scaling are the same).

On a CUDA tensor, :func:`hash_dropout` (its forward and its backward) is
one hand-written kernel, ``csrc/dropout.cu``, which applies
:func:`hash_mask`'s mask in one read and one write and launches on torch's
current stream, with nothing built on the host; it takes float32, bfloat16
and float16 and raises a ``TypeError`` on any other dtype.
``ops.launches()["dropout"]`` counts its launches. On a CPU tensor it is the
plain ``x * hash_mask(...)``, the reference; :func:`hash_mask` and
:func:`hash_bits` stay plain PyTorch, as the JAX package left them to XLA,
which fused them without Pallas on the TPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

from .. import _build
from .._device import runs_plain
from ..parallel.mesh import generator_rows

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _as_int32(value: int) -> int:
    """The int32 with the same 32 bits as the unsigned ``value``."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= 1 << 31 else value


def _keep_threshold(rate: float) -> int:
    return min(2**32 - 1, round((1.0 - rate) * 2**32))


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 → int32 tensors with the same 32 bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def hash_bits(seed: int, shape, device=None) -> torch.Tensor:
    """The murmur3 counter hash of an NCHW ``shape`` (uint32 bits held as int32)."""
    b, c, h, w = shape
    # ((b·H + h)·W + w)·C + c + seed, mod 2^32, from two small broadcast terms
    bc = torch.arange(b, dtype=torch.int64).reshape(b, 1, 1, 1) * (h * w * c) + torch.arange(
        c, dtype=torch.int64
    ).reshape(1, c, 1, 1)
    hw = (torch.arange(h, dtype=torch.int64).reshape(1, 1, h, 1) * w + torch.arange(
        w, dtype=torch.int64
    ).reshape(1, 1, 1, w)) * c
    x = _to_int32_bits(bc + seed).to(device) + _to_int32_bits(hw).to(device)
    # the int32 add above wraps mod 2^32, as JAX's uint32 iota + seed does
    x ^= (x >> 16) & 0xFFFF
    x *= _as_int32(_M1)
    x ^= (x >> 13) & 0x7FFFF
    x *= _as_int32(_M2)
    x ^= (x >> 16) & 0xFFFF
    return x


def hash_mask(seed: int, shape, rate: float, dtype, device=None) -> torch.Tensor:
    """iid Bernoulli(1-rate) keep mask of an NCHW ``shape``, pre-scaled by 1/(1-rate)."""
    bits = hash_bits(seed, shape, device)
    # unsigned x < thresh  ⇔  signed (x ^ 2^31) < thresh − 2^31
    keep = (bits ^ torch.iinfo(torch.int32).min) < (_keep_threshold(rate) - 2**31)
    return keep.to(dtype) * (1.0 / (1.0 - rate))


_BITS_SPAN = 1 << 16


def bits_threshold(rate: float) -> int:
    """The keep threshold of a 16-bit word (JAX ``_mask``, ``dropout.py:47-54``)."""
    return min(_BITS_SPAN - 1, round((1.0 - rate) * _BITS_SPAN))


def bits_mask(seed: int, shape, rate: float, dtype, device=None) -> torch.Tensor:
    """iid Bernoulli(1-rate) keep mask from 16-bit random words drawn by a
    generator on ``device`` seeded with ``seed``, pre-scaled by 1/(1-rate)."""
    device = torch.device("cpu" if device is None else device)
    generator = torch.Generator(device=device).manual_seed(seed)
    # the words held as int16: unsigned w < thresh  ⇔  signed (w − 2^15) < thresh − 2^15
    words = torch.randint(-(2**15), 2**15, tuple(shape), dtype=torch.int16, device=device, generator=generator)
    keep = words < bits_threshold(rate) - 2**15
    return keep.to(dtype) * (1.0 / (1.0 - rate))


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # the kernel's dtype codes
_KERNEL = _build.Kernel("dropout", "dropout.cu", "s2s_hash_dropout",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float])


def _hash_masked(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """``x * hash_mask(seed, ...)``: the kernel on CUDA tensors, the plain
    product on the CPU; raises for any other device."""
    if runs_plain("hash_dropout", x):
        return x * hash_mask(seed, x.shape, rate, x.dtype, x.device)
    return _launch_hash_dropout(x, seed, rate)


def _bits_masked(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    return x * bits_mask(seed, x.shape, rate, x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _keep_scale(rate: float, dtype: torch.dtype) -> float:
    """1/(1-rate) rounded as ``keep.to(dtype) * scale`` rounds it on the card:
    to float32 (the scalar's op type), then to ``dtype``."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32).to(dtype).item()


def _launch_hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """``x * hash_mask(seed, x.shape, rate, ...)`` on the card through
    ``csrc/dropout.cu``: one launch on the current stream, bit for bit the
    plain product. Raises a ``TypeError`` on a dtype the kernel does not take."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the hash dropout kernel takes {sorted(map(str, _KERNEL_DTYPES))}, not {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    b, c, h, w = x.shape
    if y.numel() == 0:
        return y
    _KERNEL.launch(x.device, x.data_ptr(), y.data_ptr(), _KERNEL_DTYPES[x.dtype], b * c, h * w, c, seed,
                   _keep_threshold(rate), _keep_scale(rate, x.dtype))
    return y


class _SeededDropout(torch.autograd.Function):
    """``masked(x, seed, rate)`` = x · mask(seed); the backward applies the
    same mask to dy, regenerated from the seed, so nothing but the seed is
    saved."""

    @staticmethod
    def forward(ctx, x, masked, seed: int, rate: float):
        ctx.masked, ctx.seed, ctx.rate = masked, seed, rate
        return masked(x, seed, rate)

    @staticmethod
    def backward(ctx, dy):
        return ctx.masked(dy, ctx.seed, ctx.rate), None, None, None


def hash_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """``x * mask / (1-rate)`` on NCHW ``x``; ``seed`` is a uint32 (a Python int),
    ``rate`` a float in (0, 1). The backward regenerates the mask from the seed.
    On the card both are ``csrc/dropout.cu`` (float32, bfloat16, float16)."""
    if x.ndim != 4:
        raise ValueError(f"hash_dropout takes NCHW tensors, got shape {tuple(x.shape)}")
    return _SeededDropout.apply(x, _hash_masked, int(seed) & 0xFFFFFFFF, float(rate))


def hardware_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """``x * mask / (1-rate)`` with the mask of :func:`bits_mask`, any shape;
    ``seed`` is a uint32 (a Python int), ``rate`` a float in (0, 1). The
    backward regenerates the mask from the seed."""
    return _SeededDropout.apply(x, _bits_masked, int(seed) & 0xFFFFFFFF, float(rate))


_RANK_STRIDE = 0x9E3779B9  # 2^32 / golden ratio


def draw_seed(generator: Optional[torch.Generator] = None) -> int:
    """One uint32 seed from ``generator`` (torch's default generator if None).

    Under data parallelism (a generator that knows this rank's rows of the
    global batch, :func:`~..parallel.mesh.generator_rows`) every rank draws the
    same seed and folds its rank in: rank ``r`` adds ``r · 0x9E3779B9``. The
    hash masks hash (element index + seed), so rank ``r``'s mask is rank 0's
    shifted by ``r · 0x9E3779B9`` elements mod 2^32: any two of 8 ranks lie
    at least 3.87e8 elements apart, more than any tensor the UNet holds (the
    first level at batch 32, 256 px: 2.68e8), so no two share mask bits. Rank 0, and
    one process, keep the drawn seed. The masks are not those of one process
    on the global batch (the index would need the example's global position,
    which the fused conv kernel does not take)."""
    seed = int(torch.randint(0, 2**32, (1,), dtype=torch.int64, generator=generator))
    rank = generator_rows(generator)[0]
    return (seed + rank * _RANK_STRIDE) & 0xFFFFFFFF


_IMPLS = {"hash": hash_dropout, "bits": hardware_dropout}


class FastDropout(nn.Module):
    """``nn.Dropout`` replacement backed by :func:`hash_dropout` (impl ``"hash"``,
    the default) or :func:`hardware_dropout` (impl ``"bits"``).

    Active in training mode only. ``forward(x, generator)`` draws this call's
    seed from ``generator``; ``forward(x, seed=s)`` uses the seed ``s`` drawn
    ahead (the UNet draws every layer's seed before its rematerialized regions).
    """

    def __init__(self, rate: float, impl: str = "hash"):
        super().__init__()
        if impl not in _IMPLS:
            raise NotImplementedError(f"FastDropout impl {impl!r} is not ported (only {sorted(_IMPLS)})")
        self.rate = float(rate)
        self.impl = impl

    def active(self) -> bool:
        """Whether a call draws a seed: training mode and 0 < rate < 1."""
        return self.training and 0.0 < self.rate < 1.0

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None, seed: Optional[int] = None
    ) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        return _IMPLS[self.impl](x, draw_seed(generator) if seed is None else seed, self.rate)

    def extra_repr(self) -> str:
        return f"rate={self.rate}, impl={self.impl!r}"


__all__ = ["hash_dropout", "hash_mask", "hash_bits", "hardware_dropout", "bits_mask", "bits_threshold", "draw_seed",
           "FastDropout"]

"""Fused GroupNorm → FiLM → SiLU → dropout → 3×3 conv, with kernels K2–K5 on the card.

Counterpart of ``stain2stain_tpu/ops/pallas_conv.py``. The TPU kernels become
CUDA C++ for ``sm_90a``, built by ``nvcc`` at first use and called through
ctypes (see the source notes for their bounds and designs):

- ``_conv_kernel`` (K2) → ``csrc/conv3x3_fwd.cu`` (:func:`fused_conv3x3`);
- ``conv3x3_input_grad`` (K3) → the same kernel with tap-flipped,
  channel-swapped weights and no prologue (:func:`conv3x3_input_grad`);
- ``_prologue_grad_kernel`` (K4) → ``csrc/prologue_grad.cu`` (:func:`prologue_grad`);
- ``_wgrad_kernel`` (K5) → ``csrc/conv3x3_wgrad.cu`` (:func:`conv3x3_weight_grad`).

Layout is the JAX package's: activations NHWC (B, H, W, C) bf16, weights
(3, 3, C, D) (HWIO), per-(B, C) f32 ``scale``/``shift``. The prologue is
n = dropout(act(x·scale + shift)), rounded to bf16 before the product; SAME
zero padding applies to n, not to x. Products accumulate in f32, the conv
output is rounded to bf16 after the f32 bias add.

Dropout: the TPU kernels draw their masks from the TPU's hardware PRNG, which
no GPU reproduces. Here the mask is the counter hash of
:mod:`.dropout` on the NHWC element index ((b·H + h)·W + w)·C + c plus the
seed (``csrc/conv_common.cuh``), kept when the bits fall below
``_keep_threshold(rate)`` and scaled by 1/(1−rate) in f32. It depends on the
element alone, never on the tile that loads it, so K2, K4 and K5 regenerate
the same mask, and an unfused ResBlock with the same seed drops the same
units. Parity with the JAX kernels is exact only at rate 0.

Each wrapper launches its kernel on CUDA tensors and raises on anything the
kernel does not take; on CPU tensors it runs the kernel's plain version
(``*_reference``, f32 products of bf16-rounded values, rounding where the
kernels round). ``ops.launches()["K2"]`` … ``["K5"]`` count the kernel
launches (K3 is K2's kernel, counted apart). K2 is the
registered op ``s2s::conv3x3_fwd`` (``torch.library.custom_op`` with a fake
implementation), so an exported bf16 ``fused_conv`` generator holds it; K3–K5
run only in the backward and stay plain functions.

:class:`_NormActConvCore` is the ``torch.autograd.Function`` in place of
``_core_fn``'s ``custom_vjp``: its forward is K2 and saves only the raw
inputs; its backward runs K3, K4 and K5. :func:`norm_act_conv` wraps it with
the GroupNorm statistics (:class:`_GNStats`, which saves only the raw input
too) and the affine fold (plain torch); autograd composes their backwards.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from .._device import runs_plain
from .dropout import _keep_threshold, hash_mask

LANE = 128
SUBLANE_BF16 = 16
_BF16 = torch.bfloat16
_F32 = torch.float32
_K4_CHANNELS = 64  # channels of a K4 block
_K4_STEP_PX = 64  # pixels of a K4 block step: 16 pixel lanes x 4 pixels in flight
# K4 blocks (128 threads) resident on one SM: its 80 registers a thread and 34
# KB of shared memory a block allow 6 (ptxas' count, printed by chip_smoke.py)
_K4_BLOCKS_PER_SM = 6
_K4_WAVES = 16  # waves of K4 blocks the slices aim at, where the pixels allow
_K5_TILE = (8, 16)  # output rows x columns of a K5 pixel tile
_K5_CHANNELS = 64  # input and output channels of a K5 block (one per SM)

_P, _I, _U, _FL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
# (scale, shift, silu, dropout, seed, keep_threshold, keep_scale): the prologue's arguments
_PROLOGUE_ARGTYPES = [_P, _P, _I, _I, _U, _U, _FL]
_CONV_ARGTYPES = [_P] * 4 + [_I] * 5 + _PROLOGUE_ARGTYPES

_K2 = _build.Kernel("K2", "conv3x3_fwd.cu", "s2s_conv3x3_fwd", _CONV_ARGTYPES)
_K3 = _build.Kernel("K3", "conv3x3_fwd.cu", "s2s_conv3x3_fwd", _CONV_ARGTYPES)
_K4 = _build.Kernel("K4", "prologue_grad.cu", "s2s_prologue_grad", [_P] * 5 + [_I] * 4 + _PROLOGUE_ARGTYPES)
_K5 = _build.Kernel("K5", "conv3x3_wgrad.cu", "s2s_conv3x3_wgrad", [_P] * 5 + [_I] * 6 + _PROLOGUE_ARGTYPES)


def supported(x_shape, w_shape) -> bool:
    """Whether the fused kernels take this conv: x (B, H, W, C), w (3, 3, C, D).

    The JAX package's predicate (``pallas_conv.py:60-70``): C and D multiples
    of 128, W a multiple of 16, H ≥ 8.
    """
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, h, w, c = x_shape
    kh, kw, ci, d = w_shape
    return (
        kh == 3 and kw == 3 and ci == c
        and c % LANE == 0 and d % LANE == 0
        and w % SUBLANE_BF16 == 0 and h >= 8
    )


def fold_norm_affine(mean, rstd, gamma, beta, film_scale=None, film_shift=None):
    """Fold GroupNorm statistics (+ optional FiLM) into per-(B, C) f32 (scale, shift).

    GroupNorm n = (x − mean)·rstd·γ + β and FiLM n·(1 + s) + t become
    x·scale + shift (``pallas_conv.py:73-88``).
    """
    gamma = gamma.to(_F32)[None, :]
    beta = beta.to(_F32)[None, :]
    scale = rstd.to(_F32) * gamma
    shift = beta - mean.to(_F32) * scale
    if film_scale is not None:
        fs = 1.0 + film_scale.to(_F32)
        scale = scale * fs
        shift = shift * fs + film_shift.to(_F32)
    return scale, shift


class _GNStats(torch.autograd.Function):
    """Per-(B, G) f32 mean and rstd of NHWC ``x``, repeated to (B, C).

    Its backward is the exact gradient of the plain composite
    (``pallas_conv.py:562-578``), but it saves only ``x`` (the tensor the
    conv core saves anyway) and the (B, G) statistics: autograd through the
    composite would keep an f32 copy of ``x`` for the square's backward.
    """

    @staticmethod
    def forward(ctx, x, groups: int, eps: float):
        b, h, w, c = x.shape
        xg = x.to(_F32).reshape(b, h * w, groups, c // groups)
        mean = xg.mean(dim=(1, 3))
        var_raw = xg.square().mean(dim=(1, 3)) - mean.square()
        # clamp: E[x^2]-E[x]^2 can cancel below -eps in f32 (``pallas_conv.py:569-572``)
        rstd = torch.rsqrt(torch.clamp(var_raw, min=0.0) + eps)
        ctx.save_for_backward(x, mean, rstd, var_raw)
        ctx.groups = groups
        reps = c // groups
        return mean.repeat_interleave(reps, dim=1), rstd.repeat_interleave(reps, dim=1)

    @staticmethod
    def backward(ctx, dmean, drstd):
        x, mean, rstd, var_raw = ctx.saved_tensors
        b, h, w, c = x.shape
        groups = ctx.groups
        reps = c // groups
        dmean = dmean.reshape(b, groups, reps).sum(dim=-1)
        # rstd = (clamp(var, 0) + eps)^-1/2; clamp passes the gradient where var >= 0
        dvar = -0.5 * drstd.reshape(b, groups, reps).sum(dim=-1) * rstd.pow(3) * (var_raw >= 0)
        dmean = dmean - 2.0 * mean * dvar  # var = E[x²] − mean²
        n = h * w * reps
        xg = x.to(_F32).reshape(b, h * w, groups, reps)
        dx = (dmean[:, None, :, None] + 2.0 * dvar[:, None, :, None] * xg) / n
        return dx.reshape(x.shape).to(x.dtype), None, None


def gn_stats(x: torch.Tensor, groups: int, eps: float = 1e-5):
    """Per-(B, C) GroupNorm (mean, rstd) in f32 of NHWC ``x``, repeated over each
    group's channels. E[x²] − E[x]² is clamped at 0, as ``pallas_conv.py:572``
    and the norms do; the backward is exact (:class:`_GNStats`)."""
    return _GNStats.apply(x, groups, eps)


# ------------------------------------------------------------ plain versions


def keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """The f32 (B, H, W, C) dropout mask of the kernels: 0 or 1/(1−rate)."""
    b, h, w, c = shape
    return hash_mask(int(seed) & 0xFFFFFFFF, (b, c, h, w), rate, _F32, device).permute(0, 2, 3, 1)


def _affine_z(x, scale, shift) -> torch.Tensor:
    z = x.to(_F32)
    if scale is not None:
        z = z * scale.to(_F32)[:, None, None, :] + shift.to(_F32)[:, None, None, :]
    return z


def _normalized(x, scale, shift, act, dropout_rate, seed) -> torch.Tensor:
    """n = dropout(act(x·scale + shift)) rounded to bf16 (``pallas_conv.py:99-125``)."""
    z = _affine_z(x, scale, shift)
    n = z * torch.sigmoid(z) if act == "silu" else z
    if dropout_rate > 0.0:
        n = n * keep_mask(_seed(seed), x.shape, dropout_rate, x.device)
    return n.to(_BF16)


def fused_conv3x3_reference(x, w, bias=None, scale=None, shift=None, act=None,
                            dropout_rate: float = 0.0, seed=None) -> torch.Tensor:
    """Plain version of K2: f32 conv of the bf16 n and bf16 w, + f32 bias, → bf16."""
    n = _normalized(x, scale, shift, act, dropout_rate, seed).to(_F32)
    wf = w.to(_BF16).to(_F32).permute(3, 2, 0, 1)  # (D, C, 3, 3)
    y = F.conv2d(n.permute(0, 3, 1, 2), wf, padding=1).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(_F32)
    return y.to(_BF16)


def _input_grad_weights(w: torch.Tensor) -> torch.Tensor:
    """flip(w)ᵀ: the (3, 3, D, C) weights whose SAME conv is the input gradient."""
    return torch.flip(w, dims=(0, 1)).permute(0, 1, 3, 2)


def conv3x3_input_grad_reference(dy, w) -> torch.Tensor:
    """Plain version of K3: dn = conv3x3_SAME(dy, flip(w)ᵀ), bf16."""
    return fused_conv3x3_reference(dy, _input_grad_weights(w))


def prologue_grad_reference(x, dn, scale=None, shift=None, act=None,
                            dropout_rate: float = 0.0, seed=None):
    """Plain version of K4: (dx in x's dtype, dscale (B, C) f32, dshift (B, C) f32)."""
    xf = x.to(_F32)
    z = _affine_z(x, scale, shift)
    dz = dn.to(x.dtype).to(_F32)
    if act == "silu":
        sig = torch.sigmoid(z)
        dz = dz * (sig * (1.0 + z * (1.0 - sig)))
    if dropout_rate > 0.0:
        dz = dz * keep_mask(_seed(seed), x.shape, dropout_rate, x.device)
    dx = dz * scale.to(_F32)[:, None, None, :] if scale is not None else dz
    return dx.to(x.dtype), (dz * xf).sum(dim=(1, 2)), dz.sum(dim=(1, 2))


def conv3x3_weight_grad_reference(x, dy, scale=None, shift=None, act=None,
                                  dropout_rate: float = 0.0, seed=None):
    """Plain version of K5: (dW (3, 3, C, D) f32, dbias (D,) f32), n recomputed."""
    n = _normalized(x, scale, shift, act, dropout_rate, seed).to(_F32)
    g = dy.to(_BF16).to(_F32)
    b, h, w, c = n.shape
    d = g.shape[-1]
    padded = F.pad(n, (0, 0, 1, 1, 1, 1))
    g2 = g.reshape(-1, d)
    taps = [
        padded[:, i:i + h, j:j + w, :].reshape(-1, c).t() @ g2
        for i in range(3) for j in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, c, d), g2.sum(dim=0)


# --------------------------------------------------------------- the kernels


def _seed(seed) -> int:
    if seed is None:
        return 0
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    return int(seed) & 0xFFFFFFFF


def _activation(x: torch.Tensor, name: str, channels: int) -> None:
    """Raise unless ``x`` is a contiguous, 16-byte aligned NHWC bf16 tensor."""
    if x.dim() != 4 or x.shape[-1] != channels:
        raise ValueError(f"{name} expects (B, H, W, {channels}) tensors, got {tuple(x.shape)}")
    if x.dtype != _BF16:
        raise TypeError(f"{name} takes bfloat16 activations, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} needs contiguous, 16-byte aligned NHWC activations")


def _prologue_args(x, scale, shift, act, dropout_rate, seed, name):
    """The C prologue arguments, with ``scale``/``shift`` made contiguous f32
    (returned too: the caller holds them until the launch is enqueued)."""
    if act not in (None, "silu"):
        raise ValueError(f"{name}: act must be None or 'silu', got {act!r}")
    if (scale is None) != (shift is None):
        raise ValueError(f"{name}: give both scale and shift, or neither")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"{name}: dropout_rate must lie in [0, 1), got {dropout_rate}")
    keep = []
    ptrs = [None, None]
    if scale is not None:
        b, c = x.shape[0], x.shape[-1]
        for i, t in enumerate((scale, shift)):
            if tuple(t.shape) != (b, c) or t.device != x.device:
                raise ValueError(f"{name}: scale and shift must be ({b}, {c}) on {x.device}")
            t = t.detach().to(_F32).contiguous()
            if t.data_ptr() % 16:  # the kernels read eight channels' factors as two float4
                t = t.clone()
            keep.append(t)
            ptrs[i] = t.data_ptr()
    drop = dropout_rate > 0.0
    args = [
        ptrs[0], ptrs[1], int(act == "silu"), int(drop), _seed(seed) if drop else 0,
        _keep_threshold(dropout_rate) if drop else 0, 1.0 / (1.0 - dropout_rate),
    ]
    return args, keep


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_conv(x, wk, bias, scale, shift, act, dropout_rate, seed, name, kernel) -> torch.Tensor:
    """y = conv3x3_SAME(prologue(x), ·) + bias through ``csrc/conv3x3_fwd.cu``
    as ``kernel`` (K2 or K3); ``wk`` is (3, 3, D, C): per tap, output channel
    rows of input channels."""
    b, h, w, c = x.shape
    d = wk.shape[2]
    _activation(x, name, c)
    if not supported(x.shape, (3, 3, c, d)) or tuple(wk.shape) != (3, 3, d, c):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)}, w {tuple(wk.shape)}")
    wk = wk.detach().to(_BF16).contiguous()
    bias = (torch.zeros(d, dtype=_F32, device=x.device) if bias is None
            else bias.detach().to(_F32).contiguous())
    pro, keep = _prologue_args(x, scale, shift, act, dropout_rate, seed, name)
    y = torch.empty((b, h, w, d), dtype=_BF16, device=x.device)
    kernel.launch(x.device, x.data_ptr(), wk.data_ptr(), bias.data_ptr(), y.data_ptr(), b, h, w, c, d, *pro)
    return y


@torch.library.custom_op("s2s::conv3x3_fwd", mutates_args=())
def _conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], scale: Optional[torch.Tensor],
                 shift: Optional[torch.Tensor], act: Optional[str], dropout_rate: float, seed: int) -> torch.Tensor:
    """The registered op of K2: the kernel on CUDA tensors (its launch counted
    here, when the op runs), the plain version on CPU tensors."""
    if runs_plain("fused_conv3x3", x, w):
        return fused_conv3x3_reference(x, w, bias, scale, shift, act, dropout_rate, seed)
    return _launch_conv(x, w.permute(0, 1, 3, 2), bias, scale, shift, act, dropout_rate, seed, "fused_conv3x3",
                        _K2)


@_conv3x3_fwd.register_fake
def _(x, w, bias, scale, shift, act, dropout_rate, seed):
    runs_plain("fused_conv3x3", x, w)  # raises for devices other than CUDA and CPU (meta)
    if not supported(x.shape, w.shape):
        raise ValueError(f"fused_conv3x3: unsupported shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    return x.new_empty((*x.shape[:3], w.shape[3]), dtype=_BF16)


def fused_conv3x3(x, w, bias=None, scale=None, shift=None, act=None,
                  dropout_rate: float = 0.0, seed=None) -> torch.Tensor:
    """K2 (the op ``s2s::conv3x3_fwd``): y = conv3x3_SAME(dropout(act(x·scale
    + shift)), w) + bias, one kernel.

    x (B, H, W, C) bf16 · w (3, 3, C, D) · scale/shift (B, C) f32 or None ·
    bias (D,) or None · ``seed`` a uint32 (int or one-element tensor) → bf16
    (B, H, W, D). Gate with :func:`supported`.
    """
    return _conv3x3_fwd(x, w, bias, scale, shift, act, float(dropout_rate), _seed(seed))


def conv3x3_input_grad(dy, w) -> torch.Tensor:
    """K3: dn = conv3x3_SAME(dy, flip(w)ᵀ), the gradient w.r.t. the normalized
    input, bf16 (B, H, W, C) from dy (B, H, W, D) and w (3, 3, C, D): K2's
    kernel with no prologue (``pallas_conv.py:307-313``)."""
    if runs_plain("conv3x3_input_grad", dy, w):
        return conv3x3_input_grad_reference(dy, w)
    # kernel layout (3, 3, out=C, in=D) of flip(w)ᵀ is flip(w) itself
    return _launch_conv(dy, torch.flip(w, dims=(0, 1)), None, None, None, None, 0.0, None, "conv3x3_input_grad",
                        _K3)


def prologue_grad(x, dn, scale=None, shift=None, act=None, dropout_rate: float = 0.0, seed=None):
    """K4: (dx bf16, dscale (B, C) f32, dshift (B, C) f32) of
    n = dropout(act(x·scale + shift)) given dn, the mask regenerated.

    Two passes without atomics: per (image, pixel slice, 64 channels) dx and
    f32 partial sums into a scratch this wrapper allocates, then an ordered
    reduction to (B, C), so two runs give the same sums. The slices come from
    :func:`prologue_grad_geometry`.
    """
    if runs_plain("prologue_grad", x, dn):
        return prologue_grad_reference(x, dn, scale, shift, act, dropout_rate, seed)
    b, h, w, c = x.shape
    _activation(x, "prologue_grad", c)
    _activation(dn, "prologue_grad", c)
    if dn.shape != x.shape or c % _K4_CHANNELS:
        raise ValueError(f"prologue_grad: x {tuple(x.shape)} and dn {tuple(dn.shape)} must match, C % 64 == 0")
    pro, keep = _prologue_args(x, scale, shift, act, dropout_rate, seed, "prologue_grad")
    slice_px, slices = prologue_grad_geometry(b, h * w, c, _sm_count(x.device))
    dx = torch.empty_like(x)
    partial = torch.empty((2, b, slices, c), dtype=_F32, device=x.device)
    sums = torch.empty((2, b, c), dtype=_F32, device=x.device)
    _K4.launch(x.device, x.data_ptr(), dn.data_ptr(), dx.data_ptr(), partial.data_ptr(), sums.data_ptr(),
               b, h * w, c, slice_px, *pro)
    return dx, sums[0], sums[1]


def prologue_grad_geometry(b: int, hw: int, c: int, sms: int):
    """K4's launch geometry: (slice_px, slices), slices = ceil(hw / slice_px).

    A block walks ``slice_px`` pixels of one image (a multiple of its 64-pixel
    step) for 64 channels. Its blocks all do the same work, so the grid's last
    wave is the one that runs part-full: the slices are cut fine enough for
    ``b · slices · C/64`` blocks to fill about sixteen waves of the card's K4
    occupancy (``_K4_BLOCKS_PER_SM`` a SM), or are one step long where an
    image has too few pixels for that (the flagship's 32² levels still fill at
    least two waves). Sixteen waves measured 1.4–2.6 % faster than eight on
    the H100 at the 128² and 256² levels. The f32 partials, (2, b, slices,
    C), are at most 12 MiB at the flagship's shapes.
    """
    steps = -(-hw // _K4_STEP_PX)
    per_slice = b * (c // _K4_CHANNELS)
    want = -(-(_K4_WAVES * _K4_BLOCKS_PER_SM * sms) // per_slice)
    slice_px = _K4_STEP_PX * max(1, steps // want)
    return slice_px, -(-hw // slice_px)


def wgrad_geometry(b: int, h: int, w: int, c: int, d: int, sms: int):
    """K5's launch geometry: (splits, shape of the f32 partials).

    A block owns 64 input × 64 output channels (all 9 taps) and walks the
    8 × 16 pixel tiles ``split, split + splits, …``; splits are chosen so
    that at most one block runs on each of the ``sms`` SMs: the grid is one
    wave (a second, nearly empty wave would double the time). Each split
    writes its 9·C·D weight partials and, per 64-channel input tile, a D-wide
    share of dbias (the tiles ``ci, ci + C/64, …`` of its walk).
    """
    th, tw = _K5_TILE
    pixel_tiles = b * -(-h // th) * (w // tw)
    blocks = (c // _K5_CHANNELS) * (d // _K5_CHANNELS)
    splits = max(1, min(pixel_tiles, sms // blocks))
    return splits, (splits, 9 * c * d + (c // _K5_CHANNELS) * d)


def conv3x3_weight_grad(x, dy, scale=None, shift=None, act=None, dropout_rate: float = 0.0, seed=None):
    """K5: (dW (3, 3, C, D) f32, dbias (D,) f32) of the fused conv, with n
    recomputed from raw x (mask included) instead of read from memory.

    Split over pixels (:func:`wgrad_geometry`): each block sums one (64 C,
    64 D) tile of all 9 taps over a share of the pixel tiles into an f32
    scratch this wrapper allocates, then an ordered reduction adds the shares,
    so two runs give the same sums.
    """
    if runs_plain("conv3x3_weight_grad", x, dy):
        return conv3x3_weight_grad_reference(x, dy, scale, shift, act, dropout_rate, seed)
    b, h, w, c = x.shape
    d = dy.shape[-1]
    _activation(x, "conv3x3_weight_grad", c)
    _activation(dy, "conv3x3_weight_grad", d)
    if dy.shape[:3] != x.shape[:3] or not supported(x.shape, (3, 3, c, d)):
        raise ValueError(f"conv3x3_weight_grad: unsupported shapes x {tuple(x.shape)}, dy {tuple(dy.shape)}")
    pro, keep = _prologue_args(x, scale, shift, act, dropout_rate, seed, "conv3x3_weight_grad")
    splits, scratch = wgrad_geometry(b, h, w, c, d, _sm_count(x.device))
    partial = torch.empty(scratch, dtype=_F32, device=x.device)
    dw = torch.empty((3, 3, c, d), dtype=_F32, device=x.device)
    dbias = torch.empty((d,), dtype=_F32, device=x.device)
    _K5.launch(x.device, x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(), dbias.data_ptr(),
               b, h, w, c, d, splits, *pro)
    return dw, dbias


# ------------------------------------------------- composed GN→SiLU→conv op


class _NormActConvCore(torch.autograd.Function):
    """conv3x3(dropout(act(x·scale + shift)), w) + bias with (x, scale, shift,
    w, bias) independent inputs (``pallas_conv.py:581-613``). The forward saves
    only the raw inputs: the backward recomputes n inside K4 and K5."""

    @staticmethod
    def forward(ctx, x, scale, shift, w, bias, act, dropout_rate, seed):
        y = fused_conv3x3(x, w, bias, scale=scale, shift=shift, act=act, dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(x, scale, shift, w)
        ctx.act, ctx.dropout_rate, ctx.seed = act, dropout_rate, seed
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, shift, w = ctx.saved_tensors
        dy = dy.to(_BF16).contiguous()
        kw = dict(scale=scale, shift=shift, act=ctx.act, dropout_rate=ctx.dropout_rate, seed=ctx.seed)
        dn = conv3x3_input_grad(dy, w)
        dx, dscale, dshift = prologue_grad(x, dn, **kw)
        dw, dbias = conv3x3_weight_grad(x, dy, **kw)
        return dx, dscale, dshift, dw.to(w.dtype), dbias, None, None, None


def norm_act_conv(x, w, bias, gamma, beta, film_scale=None, film_shift=None, groups: int = 32,
                  eps: float = 1e-5, act: Optional[str] = "silu", dropout_rate: float = 0.0,
                  seed=None) -> torch.Tensor:
    """GroupNorm(+FiLM) → SiLU → dropout → 3×3 conv of NHWC ``x`` as K2 forward
    and K3–K5 backward (``pallas_conv.py:616-647``).

    w (3, 3, C, D) (any float dtype; its gradient comes back in that dtype),
    bias (D,), gamma/beta (C,), film_scale/film_shift (B, C) or None → bf16
    (B, H, W, D). Differentiable in every tensor argument: the statistics and
    the fold are plain torch, composed with the core's backward by autograd.
    Only raw inputs are kept for the backward; n never reaches memory.
    """
    mean, rstd = gn_stats(x, groups, eps)
    scale, shift = fold_norm_affine(mean, rstd, gamma, beta, film_scale, film_shift)
    return _NormActConvCore.apply(
        x.to(_BF16).contiguous(), scale, shift, w, bias, act, float(dropout_rate), _seed(seed)
    )


__all__ = [
    "conv3x3_input_grad",
    "conv3x3_input_grad_reference",
    "conv3x3_weight_grad",
    "conv3x3_weight_grad_reference",
    "fold_norm_affine",
    "fused_conv3x3",
    "fused_conv3x3_reference",
    "gn_stats",
    "keep_mask",
    "norm_act_conv",
    "prologue_grad",
    "prologue_grad_geometry",
    "prologue_grad_reference",
    "supported",
    "wgrad_geometry",
]

"""GroupNorm ops of the UNet with memory-lean backwards
(counterpart of ``stain2stain_tpu/ops/norms.py``), and the DiT's LayerNorm.

Three variants cover every norm site of the ADM UNet:

- :func:`group_norm`            — plain GN (attention pre-norm)
- :func:`group_norm_silu`       — GN → SiLU (res-block entry, final out norm)
- :func:`group_norm_film_silu`  — GN → h·(1+scale)+shift → SiLU (FiLM
  ``use_scale_shift_norm`` conditioning inside res blocks)

and one covers every norm site of the DiT (``models/dit.py``), which the JAX
package does not have:

- :func:`layer_norm_modulate`   — LN without affine → x̂·(1+scale)+shift, scale
  and shift per sample (adaLN), the statistics in f32 from the centred form;
  on CUDA tensors two hand-written kernels (``csrc/layer_norm_modulate.cu``:
  :func:`ln_modulate_fwd`, :func:`ln_modulate_bwd`), on CPU tensors the plain
  chain

The math is the JAX package's: f32 statistics from the E[x²]−E[x]² form,
variance clamped at 0, output in x's dtype. Layout is NCHW (channels second),
the UNet's internal layout; the JAX ops take NHWC.

Each op is a ``torch.autograd.Function`` in place of the JAX ``custom_vjp``:
it saves only (x, gamma[, beta, scale, shift], mean, rstd) — x in its compute
dtype, already kept for the preceding conv's backward — and recomputes x̂,
FiLM and SiLU in the backward. As in JAX (``norms.py:55-71, 129, 168``) the
large backward tensors stay in the compute dtype and the reductions run in
f32. The GroupNorm ops are plain PyTorch: XLA fused them without Pallas on
the TPU, so no kernel stands behind them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

_F32 = torch.float32


def _stats(x: torch.Tensor, groups: int, eps: float):
    """Per-(batch, group) f32 mean and rstd of an NCHW tensor."""
    xg = x.reshape(x.shape[0], groups, -1).to(_F32)
    mean = xg.mean(dim=-1)
    mean2 = xg.square().mean(dim=-1)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)  # (B, G) each


def _per_channel(stat: torch.Tensor, channels: int, ndim: int) -> torch.Tensor:
    """(B, G) → (B, C, 1, …) by repeating each group's value over its channels."""
    b, g = stat.shape
    return stat.repeat_interleave(channels // g, dim=1).reshape((b, channels) + (1,) * (ndim - 2))


def _affine(p: torch.Tensor, ndim: int) -> torch.Tensor:
    return p.reshape((1, -1) + (1,) * (ndim - 2))


def _xhat(x, mean, rstd):
    c, nd = x.shape[1], x.ndim
    return (x.to(_F32) - _per_channel(mean, c, nd)) * _per_channel(rstd, c, nd)


def _sum_nhw(t: torch.Tensor) -> torch.Tensor:
    """Sum of an f32 (B, C, …) tensor over everything but the channels."""
    return t.sum(dim=[0] + list(range(2, t.ndim)))


def _dx_from_dxhat(dxhat, xhat, rstd, groups: int):
    """dL/dx given dL/dx̂: r·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)), means per group.

    Large tensors stay in ``dxhat.dtype``; the group means accumulate in f32.
    """
    b, c = dxhat.shape[:2]
    cdt = dxhat.dtype

    def gmean(t):
        m = t.reshape(b, groups, -1).to(_F32).mean(dim=-1)
        return _per_channel(m, c, t.ndim).to(cdt)

    rstd_c = _per_channel(rstd, c, dxhat.ndim).to(cdt)
    return rstd_c * (dxhat - gmean(dxhat) - xhat * gmean(dxhat * xhat))


def _silu_grad(z):
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float):
        mean, rstd = _stats(x, groups, eps)
        y = _xhat(x, mean, rstd) * _affine(gamma.to(_F32), x.ndim) + _affine(beta.to(_F32), x.ndim)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.groups = groups
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, mean, rstd = ctx.saved_tensors
        cdt = x.dtype  # big tensors in the compute dtype; f32 for reductions
        dy = dy.to(cdt)
        xhat = _xhat(x, mean, rstd).to(cdt)
        dgamma = _sum_nhw((dy * xhat).to(_F32))
        dbeta = _sum_nhw(dy.to(_F32))
        dx = _dx_from_dxhat(dy * _affine(gamma.to(cdt), x.ndim), xhat, rstd, ctx.groups)
        return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float):
        mean, rstd = _stats(x, groups, eps)
        z = _xhat(x, mean, rstd) * _affine(gamma.to(_F32), x.ndim) + _affine(beta.to(_F32), x.ndim)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.groups = groups
        return F.silu(z).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        cdt, nd = x.dtype, x.ndim
        xhat32 = _xhat(x, mean, rstd)
        z = xhat32 * _affine(gamma.to(_F32), nd) + _affine(beta.to(_F32), nd)
        dz = dy.to(cdt) * _silu_grad(z).to(cdt)  # compute-dtype boundary, as JAX
        dz32 = dz.to(_F32)
        dgamma = _sum_nhw(dz32 * xhat32)
        dbeta = _sum_nhw(dz32)
        dx = _dx_from_dxhat(dz * _affine(gamma.to(cdt), nd), xhat32.to(cdt), rstd, ctx.groups)
        return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None


class _GroupNormFiLMSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups: int, eps: float):
        mean, rstd = _stats(x, groups, eps)
        g = _xhat(x, mean, rstd) * _affine(gamma.to(_F32), x.ndim) + _affine(beta.to(_F32), x.ndim)
        z = g * (1.0 + scale.to(_F32)) + shift.to(_F32)
        ctx.save_for_backward(x, gamma, beta, scale, shift, mean, rstd)
        ctx.groups = groups
        return F.silu(z).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, scale, shift, mean, rstd = ctx.saved_tensors
        cdt, nd = x.dtype, x.ndim
        xhat32 = _xhat(x, mean, rstd)
        g = xhat32 * _affine(gamma.to(_F32), nd) + _affine(beta.to(_F32), nd)
        one_p_scale = 1.0 + scale.to(_F32)
        z = g * one_p_scale + shift.to(_F32)
        dz = dy.to(cdt) * _silu_grad(z).to(cdt)
        dz32 = dz.to(_F32)
        spatial = list(range(2, nd))
        dscale = (dz32 * g).sum(dim=spatial, keepdim=True)
        dshift = dz32.sum(dim=spatial, keepdim=True)
        dg = dz * one_p_scale.to(cdt)
        dg32 = dg.to(_F32)
        dgamma = _sum_nhw(dg32 * xhat32)
        dbeta = _sum_nhw(dg32)
        dx = _dx_from_dxhat(dg * _affine(gamma.to(cdt), nd), xhat32.to(cdt), rstd, ctx.groups)
        return (
            dx.to(x.dtype),
            dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype),
            dscale.reshape(scale.shape).to(scale.dtype),
            dshift.reshape(shift.shape).to(shift.dtype),
            None,
            None,
        )


class _LayerNormModulate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, shift, eps: float, dtype):
        acc = torch.promote_types(x.dtype, _F32)  # f32 statistics (f64 stays f64: gradcheck)
        xa = x.to(acc)
        var, mean = torch.var_mean(xa, dim=-1, unbiased=False, keepdim=True)
        rstd = torch.rsqrt(var + eps)
        y = (xa - mean) * rstd * (1.0 + scale.to(acc)[:, None]) + shift.to(acc)[:, None]
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.shift_dtype = shift.dtype
        return y.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        acc = mean.dtype
        dy32 = dy.to(acc)
        xhat = (x.to(acc) - mean) * rstd
        dshift = dy32.sum(dim=1)
        dscale = (dy32 * xhat).sum(dim=1)
        dxhat = dy32 * (1.0 + scale.to(acc)[:, None])
        dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True) - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), dshift.to(ctx.shift_dtype), None, None


_LN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' dtype codes
LN_MAX_CHANNELS = 1152  # DiT-XL/2's width, the widest DiT (the kernels' compiled limit)
_LN_ROWS_PER_BLOCK = 64  # token rows of one sample a backward block takes


def _ln_modulate_check(x, scale, shift, dtype) -> None:
    """Raises a ``ValueError`` naming what the kernels do not take."""
    for what, dt in (("x", x.dtype), ("scale", scale.dtype), ("shift", shift.dtype), ("the output", dtype)):
        if dt not in _LN_DTYPES:
            raise ValueError(f"the LayerNorm-modulate kernels take float32 or bfloat16 {what}, not {dt}")
    if scale.dtype != shift.dtype:
        raise ValueError(f"the LayerNorm-modulate kernels take scale and shift of one dtype, not {scale.dtype} "
                         f"and {shift.dtype}")
    if x.ndim != 3 or scale.shape != (x.shape[0], x.shape[2]) or shift.shape != scale.shape:
        raise ValueError(f"the LayerNorm-modulate kernels take (B, T, C) x and (B, C) scale and shift, not "
                         f"{tuple(x.shape)}, {tuple(scale.shape)}, {tuple(shift.shape)}")
    c = x.shape[2]
    if c % 8 or not 0 < c <= LN_MAX_CHANNELS:
        raise ValueError(f"the LayerNorm-modulate kernels take C a multiple of 8 up to {LN_MAX_CHANNELS}, not {c}")
    if scale.device != x.device or shift.device != x.device:
        raise ValueError(f"the LayerNorm-modulate kernels take x, scale and shift on one device, not {x.device}, "
                         f"{scale.device}, {shift.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy only where it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _param_rows(scale: torch.Tensor, shift: torch.Tensor):
    """(B, C) scale and shift as the kernels read them: unit channel stride, one
    row stride that is a multiple of 8 elements, 16-byte aligned. The adaLN
    layer's chunks pass as they are."""
    def fits(p):
        return p.stride(1) == 1 and p.stride(0) % 8 == 0 and p.data_ptr() % 16 == 0

    if not (fits(scale) and fits(shift) and scale.stride(0) == shift.stride(0)):
        scale, shift = _aligned(scale), _aligned(shift)
    return scale, shift


def _ln_kernel(name: str, argtypes: list):
    fn = getattr(_build.load("layer_norm_modulate.cu"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def ln_modulate_fwd(x, scale, shift, eps: float, dtype):
    """LayerNorm-modulate of (B, T, C) ``x`` on the card (``csrc/layer_norm_modulate.cu``,
    one launch on the current stream): (y in ``dtype``, mean, rstd), the last two
    (B, T) f32. Raises a ``ValueError`` on what the kernel does not take."""
    _ln_modulate_check(x, scale, shift, dtype)
    x = _aligned(x)
    scale, shift = _param_rows(scale, shift)
    b, t, c = x.shape
    y = torch.empty((b, t, c), dtype=dtype, device=x.device)
    mean = torch.empty((b, t), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if y.numel() == 0:
        return y, mean, rstd
    fn = _ln_kernel("s2s_ln_modulate_fwd", [_PTR, _PTR, _INT, _INT, _PTR, _PTR, _I64, _INT, _PTR, _PTR, _I64, _INT,
                                            _INT, ctypes.c_float, _PTR])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), _LN_DTYPES[x.dtype], _LN_DTYPES[dtype], scale.data_ptr(),
                 shift.data_ptr(), scale.stride(0), _LN_DTYPES[scale.dtype], mean.data_ptr(), rstd.data_ptr(), b * t,
                 t, c, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"ln_modulate_fwd kernel launch failed: cudaError {err}")
    ln_modulate_fwd.launches += 1
    return y, mean, rstd


ln_modulate_fwd.launches = 0


def ln_modulate_bwd(x, dy, scale, mean, rstd, shift_dtype):
    """The gradients (dx in x's dtype, dscale in scale's, dshift in
    ``shift_dtype``) of :func:`ln_modulate_fwd` from its (x, scale, mean, rstd)
    and dy on the card: the rows' kernel, then the per-sample sums, in a fixed
    order (no atomics)."""
    _ln_modulate_check(x, scale, scale, dy.dtype)
    if shift_dtype != scale.dtype:
        raise ValueError(f"the LayerNorm-modulate kernels take scale and shift of one dtype, not {scale.dtype} "
                         f"and {shift_dtype}")
    x, dy = _aligned(x), _aligned(dy)
    scale, _ = _param_rows(scale, scale)
    b, t, c = x.shape
    if dy.shape != x.shape or mean.shape != (b, t) or rstd.shape != (b, t) or not (mean.is_contiguous()
                                                                                  and rstd.is_contiguous()):
        raise ValueError(f"ln_modulate_bwd takes dy like x {tuple(x.shape)} and contiguous (B, T) mean and rstd, not "
                         f"{tuple(dy.shape)}, {tuple(mean.shape)}, {tuple(rstd.shape)}")
    dx = torch.empty_like(x)
    dscale = torch.empty((b, c), dtype=scale.dtype, device=x.device)
    dshift = torch.empty((b, c), dtype=shift_dtype, device=x.device)
    if x.numel() == 0:
        return dx, dscale.zero_(), dshift.zero_()
    blocks = -(-t // _LN_ROWS_PER_BLOCK)
    partial = torch.empty((b, blocks, 2, c), dtype=torch.float32, device=x.device)
    fn = _ln_kernel("s2s_ln_modulate_bwd", [_PTR, _PTR, _INT, _INT, _PTR, _I64, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
                                            _PTR, _INT, _INT, _INT, _INT, _PTR])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dy.data_ptr(), _LN_DTYPES[x.dtype], _LN_DTYPES[dy.dtype], scale.data_ptr(),
                 scale.stride(0), _LN_DTYPES[scale.dtype], mean.data_ptr(), rstd.data_ptr(),
                 dx.data_ptr(), partial.data_ptr(), dscale.data_ptr(), dshift.data_ptr(), b, t, c,
                 _LN_ROWS_PER_BLOCK, stream)
    if err != 0:
        raise RuntimeError(f"ln_modulate_bwd kernel launch failed: cudaError {err}")
    ln_modulate_bwd.launches += 1
    return dx, dscale, dshift


ln_modulate_bwd.launches = 0


class _LayerNormModulateKernel(torch.autograd.Function):
    """:class:`_LayerNormModulate` on the card: the forward and the backward are
    one kernel each; it saves the same (x, scale, mean, rstd)."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps: float, dtype):
        y, mean, rstd = ln_modulate_fwd(x, scale, shift, eps, dtype)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.shift_dtype = shift.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dshift = ln_modulate_bwd(x, dy, scale, mean, rstd, ctx.shift_dtype)
        return dx, dscale, dshift, None, None


def layer_norm_modulate(x, scale, shift, eps: float = 1e-6, dtype=None) -> torch.Tensor:
    """LayerNorm of (B, T, C) ``x`` over C without affine, then x̂·(1+scale)+shift
    with (B, C) ``scale`` and ``shift`` per sample; f32 statistics, the result
    in ``dtype`` (x's by default). The backward saves (x, scale, mean, rstd)
    and recomputes x̂; its reductions run in f32. On a CUDA ``x`` both are the
    kernels of :func:`ln_modulate_fwd` and :func:`ln_modulate_bwd` (float32 or
    bfloat16, C a multiple of 8 up to ``LN_MAX_CHANNELS``; anything else raises
    a ``ValueError``); elsewhere the plain chain."""
    op = _LayerNormModulateKernel if x.device.type == "cuda" else _LayerNormModulate
    return op.apply(x, scale, shift, eps, dtype or x.dtype)


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm; returns x.dtype. gamma/beta (C,) f32."""
    return _GroupNorm.apply(x, gamma, beta, groups, eps)


def group_norm_silu(x, gamma, beta, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)); returns x.dtype."""
    return _GroupNormSiLU.apply(x, gamma, beta, groups, eps)


def group_norm_film_silu(x, gamma, beta, scale, shift, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)·(1+scale)+shift); scale/shift (B, C, 1, 1) or broadcastable."""
    return _GroupNormFiLMSiLU.apply(x, gamma, beta, scale, shift, groups, eps)


__all__ = ["group_norm", "group_norm_silu", "group_norm_film_silu", "layer_norm_modulate", "ln_modulate_fwd",
           "ln_modulate_bwd"]

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
  and shift per sample (adaLN), the statistics in f32 from the centred form

The math is the JAX package's: f32 statistics from the E[x²]−E[x]² form,
variance clamped at 0, output in x's dtype. Layout is NCHW (channels second),
the UNet's internal layout; the JAX ops take NHWC.

Each op is a ``torch.autograd.Function`` in place of the JAX ``custom_vjp``:
it saves only (x, gamma[, beta, scale, shift], mean, rstd) — x in its compute
dtype, already kept for the preceding conv's backward — and recomputes x̂,
FiLM and SiLU in the backward. As in JAX (``norms.py:55-71, 129, 168``) the
large backward tensors stay in the compute dtype and the reductions run in
f32. These are plain PyTorch: XLA fused them without Pallas on the TPU, so
no kernel stands behind them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def layer_norm_modulate(x, scale, shift, eps: float = 1e-6, dtype=None) -> torch.Tensor:
    """LayerNorm of (B, T, C) ``x`` over C without affine, then x̂·(1+scale)+shift
    with (B, C) ``scale`` and ``shift`` per sample; f32 statistics, the result
    in ``dtype`` (x's by default). The backward saves (x, scale, mean, rstd)
    and recomputes x̂; its reductions run in f32."""
    return _LayerNormModulate.apply(x, scale, shift, eps, dtype or x.dtype)


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm; returns x.dtype. gamma/beta (C,) f32."""
    return _GroupNorm.apply(x, gamma, beta, groups, eps)


def group_norm_silu(x, gamma, beta, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)); returns x.dtype."""
    return _GroupNormSiLU.apply(x, gamma, beta, groups, eps)


def group_norm_film_silu(x, gamma, beta, scale, shift, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)·(1+scale)+shift); scale/shift (B, C, 1, 1) or broadcastable."""
    return _GroupNormFiLMSiLU.apply(x, gamma, beta, scale, shift, groups, eps)


__all__ = ["group_norm", "group_norm_silu", "group_norm_film_silu", "layer_norm_modulate"]

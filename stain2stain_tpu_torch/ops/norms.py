"""GroupNorm forwards of the UNet (counterpart of ``stain2stain_tpu/ops/norms.py``).

Three variants cover every norm site of the ADM UNet:

- :func:`group_norm`            — plain GN (attention pre-norm)
- :func:`group_norm_silu`       — GN → SiLU (res-block entry, final out norm)
- :func:`group_norm_film_silu`  — GN → h·(1+scale)+shift → SiLU (FiLM
  ``use_scale_shift_norm`` conditioning inside res blocks)

The math is the JAX package's: f32 statistics from the E[x²]−E[x]² form,
variance clamped at 0, output in x's dtype. Layout is NCHW (channels second),
the UNet's internal layout. These are plain PyTorch: XLA fused them without
Pallas on the TPU, so no kernel stands behind them. Their memory-lean
backwards (saving only x, mean, rstd) come with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _normalize(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float):
    """f32 GroupNorm of an NCHW tensor followed by the per-channel affine."""
    b, c = x.shape[:2]
    xg = x.reshape(b, groups, -1).to(torch.float32)
    mean = xg.mean(dim=-1, keepdim=True)
    mean2 = xg.square().mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    xhat = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    affine = (c,) + (1,) * (x.ndim - 2)
    return xhat * gamma.to(torch.float32).reshape(affine) + beta.to(torch.float32).reshape(affine)


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm; returns x.dtype. gamma/beta (C,) f32."""
    return _normalize(x, gamma, beta, groups, eps).to(x.dtype)


def group_norm_silu(x, gamma, beta, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)); returns x.dtype."""
    return F.silu(_normalize(x, gamma, beta, groups, eps)).to(x.dtype)


def group_norm_film_silu(x, gamma, beta, scale, shift, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """SiLU(GroupNorm(x)·(1+scale)+shift); scale/shift (B, C, 1, 1) or broadcastable."""
    g = _normalize(x, gamma, beta, groups, eps)
    z = g * (1.0 + scale.to(torch.float32)) + shift.to(torch.float32)
    return F.silu(z).to(x.dtype)


__all__ = ["group_norm", "group_norm_silu", "group_norm_film_silu"]

"""Sinusoidal timestep embeddings (counterpart of ``stain2stain_tpu/ops/time_embedding.py``).

- :func:`timestep_embedding_adm`, the ADM UNet's: frequencies
  ``exp(-ln(max_period) · i / half)`` with ``[cos ‖ sin]`` order (``:22-31``);
- :func:`timestep_embedding_sincos`, the multitask flow decoder's: frequencies
  ``exp(-ln(max_period) · i / (half - 1))`` with ``[sin ‖ cos]`` order
  (``:34-44``).
"""

from __future__ import annotations

import math

import torch


def timestep_embedding_adm(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """ADM-style embedding of continuous timesteps ``t`` (B,) → (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def timestep_embedding_sincos(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Shared-encoder embedding of continuous timesteps ``t`` (B,) → (B, dim) f32: ``[sin ‖ cos]``."""
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(max_period) / max(half - 1, 1))
    )
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


__all__ = ["timestep_embedding_adm", "timestep_embedding_sincos"]

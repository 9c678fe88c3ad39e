"""Sinusoidal timestep embedding of the ADM UNet.

Counterpart of ``stain2stain_tpu/ops/time_embedding.py::timestep_embedding_adm``:
frequencies ``exp(-ln(max_period) · i / half)`` with ``[cos ‖ sin]`` order.
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


__all__ = ["timestep_embedding_adm"]

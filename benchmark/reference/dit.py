"""The plain reference of the DiT velocity net, in plain PyTorch.

The adaLN-Zero diffusion transformer of Peebles & Xie 2023
(https://arxiv.org/abs/2212.09748, ``facebookresearch/DiT`` ``models.py``):
its parameter names (``x_embedder.proj``, ``t_embedder.mlp.0/2``,
``blocks.{i}.attn.qkv/proj``, ``blocks.{i}.mlp.fc1/fc2``,
``blocks.{i}.adaLN_modulation.1``, ``final_layer.adaLN_modulation.1``,
``final_layer.linear``), its equations (a p × p patch conv plus fixed 2-D
sin-cos positions; the 256-wide sinusoidal t embedding through Linear → SiLU →
Linear; per block ``x += g1·Attn(LN(x)·(1+s1)+b1)`` and ``x += g2·MLP(LN(x)·(1+s2)+b2)``
with LayerNorm without affine at eps 1e-6, tanh GELU, the six modulations a
dense layer of SiLU(c); a final adaLN layer and the linear unpatchify).
Written from the published design, not from the measured program, and
importing none of it. The configuration's departures are the program's too:
pixel patches, no class embedding, a velocity of ``out_channels`` (no
learned-sigma half), no dropout (``dropout_layers`` is empty).

Every product (the patch conv, each dense layer, both attention products) goes
through :func:`benchmark.reference.common.conv` or the context's ``cast``, so
the control computes it in a lower precision. Inputs and outputs are NCHW f32;
everything runs in float32; on the card the caller turns TF32 off.

The module meets the interface of a configuration's ``reference``
(``benchmark/README.md``): :func:`build`, the net's ``dropout_layers``,
:func:`attention_shapes` and :func:`zeroed`; no fused convolutions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.common import Ctx, conv, timestep_embedding

FREQUENCY_EMBEDDING_SIZE = 256


def pos_embed_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """DiT's ``get_1d_sincos_pos_embed_from_grid``."""
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed_2d(embed_dim: int, grid_size: int) -> np.ndarray:
    """DiT's ``get_2d_sincos_pos_embed``: (grid², embed_dim), the grid from
    ``np.meshgrid(w, h)`` (w first), the first half embedding it."""
    grid = np.stack(np.meshgrid(np.arange(grid_size, dtype=np.float32), np.arange(grid_size, dtype=np.float32)), 0)
    grid = grid.reshape(2, 1, grid_size, grid_size)
    return np.concatenate([pos_embed_1d(embed_dim // 2, grid[0]), pos_embed_1d(embed_dim // 2, grid[1])], axis=1)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


class _PatchEmbed(nn.Module):
    def __init__(self, channels: int, hidden: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(channels, hidden, patch, stride=patch)


class _TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQUENCY_EMBEDDING_SIZE, hidden), nn.SiLU(), nn.Linear(hidden, hidden))


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.proj = nn.Linear(hidden, hidden)

    def forward(self, x, ctx: Ctx):
        r = ctx.cast
        b, t, c = x.shape
        d = c // self.heads
        q, k, v = conv(self.qkv, x, ctx).reshape(b, t, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        logits = r.out(r.inp(q) @ r.inp(k).transpose(-1, -2)) * d ** -0.5
        a = r.out(r.inp(torch.softmax(logits, dim=-1)) @ r.inp(v))
        return conv(self.proj, a.transpose(1, 2).reshape(b, t, c), ctx)


class _Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden)

    def forward(self, x, ctx: Ctx):
        return conv(self.fc2, F.gelu(conv(self.fc1, x, ctx), approximate="tanh"), ctx)


class _Block(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = _Attention(hidden, heads)
        self.mlp = _Mlp(hidden, int(hidden * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 6 * hidden))

    def forward(self, x, c, ctx: Ctx):
        shift1, scale1, gate1, shift2, scale2, gate2 = conv(self.adaLN_modulation[1], F.silu(c), ctx).chunk(6, dim=1)
        width = (x.shape[-1],)
        x = x + gate1[:, None] * self.attn(_modulate(F.layer_norm(x, width, eps=1e-6), shift1, scale1), ctx)
        return x + gate2[:, None] * self.mlp(_modulate(F.layer_norm(x, width, eps=1e-6), shift2, scale2), ctx)


class _FinalLayer(nn.Module):
    def __init__(self, hidden: int, patch: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden, patch * patch * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden, 2 * hidden))

    def forward(self, x, c, ctx: Ctx):
        shift, scale = conv(self.adaLN_modulation[1], F.silu(c), ctx).chunk(2, dim=1)
        return conv(self.linear, _modulate(F.layer_norm(x, (x.shape[-1],), eps=1e-6), shift, scale), ctx)


class DiT(nn.Module):
    """``forward(t, x, ctx)``: t (B,), x (B, C, H, W) → the velocity (B, C_out, H, W)."""

    def __init__(self, channels: int, size: int, patch: int, hidden: int, depth: int, heads: int,
                 mlp_ratio: float, out_channels: int):
        super().__init__()
        self.patch, self.out_channels = patch, out_channels
        self.x_embedder = _PatchEmbed(channels, hidden, patch)
        self.t_embedder = _TimestepEmbedder(hidden)
        self.blocks = nn.ModuleList([_Block(hidden, heads, mlp_ratio) for _ in range(depth)])
        self.final_layer = _FinalLayer(hidden, patch, out_channels)
        pos = torch.tensor(pos_embed_2d(hidden, size // patch), dtype=torch.float32)[None]
        self.register_buffer("pos_embed", pos, persistent=False)
        self.dropout_layers = []

    def forward(self, t, x, ctx: Ctx = None):
        ctx = ctx or Ctx()
        b, _, h, w = x.shape
        p = self.patch
        tokens = conv(self.x_embedder.proj, x, ctx).flatten(2).transpose(1, 2) + self.pos_embed
        mlp = self.t_embedder.mlp
        c = conv(mlp[2], F.silu(conv(mlp[0], timestep_embedding(t, FREQUENCY_EMBEDDING_SIZE), ctx)), ctx)
        for block in self.blocks:
            tokens = block(tokens, c, ctx)
        out = self.final_layer(tokens, c, ctx).reshape(b, h // p, w // p, p, p, self.out_channels)
        return torch.einsum("nhwpqc->nchpwq", out).reshape(b, self.out_channels, h, w)


def build(net_cfg: dict, device=None) -> DiT:
    channels, size = int(net_cfg["dim"][0]), int(net_cfg["dim"][1])
    with torch.device(device or "cpu"):
        return DiT(channels, size, int(net_cfg["patch_size"]), int(net_cfg["hidden_size"]), int(net_cfg["depth"]),
                   int(net_cfg["num_heads"]), float(net_cfg["mlp_ratio"]),
                   int(net_cfg.get("out_channels") or channels))


def attention_shapes(net_cfg: dict, size: int) -> list:
    """(heads, T, d) of each block's attention on a ``size``-px tile."""
    heads, hidden = int(net_cfg["num_heads"]), int(net_cfg["hidden_size"])
    tokens = (int(size) // int(net_cfg["patch_size"])) ** 2
    return [(heads, tokens, hidden // heads)] * int(net_cfg["depth"])


def zeroed(name: str) -> bool:
    """The adaLN-Zero layers and the final linear: DiT's recipe initializes them at zero."""
    return ".adaLN_modulation.1." in name or name.startswith("final_layer.linear.")

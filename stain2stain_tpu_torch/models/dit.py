"""DiT velocity network: the adaLN-Zero diffusion transformer of Peebles & Xie,
*Scalable Diffusion Models with Transformers* (https://arxiv.org/abs/2212.09748,
``facebookresearch/DiT`` ``models.py``), trained as a flow-matching velocity
field as SiT does (https://arxiv.org/abs/2401.08740). The JAX package has no
counterpart.

The published equations and parameter names:

- ``x_embedder.proj``: a p × p patch embedding of the tile (a stride-p conv,
  run as one dense layer over the flattened patches), plus fixed 2-D sin-cos
  positions (``pos_embed``, a buffer: not a parameter, not in the optimizer);
- ``t_embedder.mlp.0/2``: the sinusoidal embedding of t (256 wide, DiT's
  ``TimestepEmbedder.timestep_embedding``, which is
  :func:`..ops.time_embedding.timestep_embedding_adm`) through Linear → SiLU
  → Linear; t in [0, 1], unscaled;
- ``depth`` adaLN-Zero blocks: ``adaLN_modulation.1`` maps SiLU(c) to six
  per-sample vectors (shift, scale and gate for attention and for the MLP), and
  ``x = x + g1·Attn(LN(x)·(1+s1)+b1)``, ``x = x + g2·MLP(LN(x)·(1+s2)+b2)``,
  LayerNorm without affine at eps 1e-6 (:func:`..ops.norms.layer_norm_modulate`),
  attention ``attn.qkv``/``attn.proj`` through :func:`..ops.attention.attention`
  (kernel K1 on the card), MLP ``mlp.fc1``/``mlp.fc2`` with tanh GELU;
- ``final_layer``: adaLN (``adaLN_modulation.1``, shift and scale) and the
  ``linear`` unpatchify to p × p × out_channels.

Departures, for a stain translator: pixel patches in place of the SD-VAE
latent; no class embedding (the source stain is the ODE's start); a velocity of
``out_channels`` (no learned-sigma half: flow matching has no variance to
learn); no dropout. Weights are initialized by DiT's ``initialize_weights``:
xavier-uniform dense kernels and zero biases, N(0, 0.02) for the t-embedding
MLP, and zero for every ``adaLN_modulation.1`` and ``final_layer.linear``, so
at initialization every block is the identity and the velocity is zero.

The port's calling convention: ``forward(t, x, y=None, generator=None)`` on NHWC
(B, H, W, C) tiles, returning the f32 NHWC velocity. ``dtype`` is the compute
type (the trainer sets bfloat16 under ``bf16-mixed``): parameters stay f32,
each dense layer casts its input and weight to it, the residual stream and the
norms' statistics stay f32. The forward opens the spans ``dit.embed``,
``dit.blocks`` (``blocks``, ``tokens`` a tile) and ``dit.final`` under a
traced train step (:mod:`..utils.tracing`), none while ``torch.compile`` or
``torch.export`` traces. There is no fallback: a CUDA head dim that K1 does
not take raises.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.attention import attention
from ..ops.norms import layer_norm_modulate
from ..ops.time_embedding import timestep_embedding_adm
from ..utils import tracing

FREQUENCY_EMBEDDING_SIZE = 256  # DiT's TimestepEmbedder


def _dense(layer: nn.Linear, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(h.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _span(name: str, **attrs: int):
    return contextlib.nullcontext() if torch.compiler.is_compiling() else tracing.span(name, **attrs)


def sincos_pos_embed(hidden_size: int, grid_size: int) -> torch.Tensor:
    """DiT's ``get_2d_sincos_pos_embed`` (f64, then f32): (grid², hidden); token
    i·grid + j's first half embeds its column j, its second half its row i,
    each as [sin ‖ cos] at frequencies 10000^(-k / (hidden/4))."""
    quarter = hidden_size // 4
    omega = 1.0 / 10000 ** (torch.arange(quarter, dtype=torch.float64, device="cpu") / quarter)
    grid = torch.arange(grid_size, dtype=torch.float64, device="cpu")
    rows, cols = torch.meshgrid(grid, grid, indexing="ij")

    def embed(pos):
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([embed(cols), embed(rows)], dim=1).to(torch.float32)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(FREQUENCY_EMBEDDING_SIZE, hidden_size), nn.SiLU(),
                                 nn.Linear(hidden_size, hidden_size))

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _dense(self.mlp[0], timestep_embedding_adm(t, FREQUENCY_EMBEDDING_SIZE), dtype)
        return _dense(self.mlp[2], F.silu(h), dtype)


class Attention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by num_heads={num_heads}")
        self.num_heads = num_heads
        self.qkv = nn.Linear(hidden_size, 3 * hidden_size)
        self.proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, t, c = h.shape
        heads = self.num_heads
        d = c // heads
        # one copy into (3, B, heads, T, d): K1's folded (B·heads, T, d) operands are views of it
        q, k, v = _dense(self.qkv, h, dtype).reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4).contiguous()
        out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), d).reshape(b, t, c)
        return _dense(self.proj, out, dtype)


class Mlp(nn.Module):
    def __init__(self, hidden_size: int, mlp_hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden_size, mlp_hidden)
        self.fc2 = nn.Linear(mlp_hidden, hidden_size)

    def forward(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _dense(self.fc2, F.gelu(_dense(self.fc1, h, dtype), approximate="tanh"), dtype)


class DiTBlock(nn.Module):
    """One adaLN-Zero block: attention and MLP, each on a modulated LayerNorm, each gated."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.attn = Attention(hidden_size, num_heads)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 6 * hidden_size))

    def forward(self, x: torch.Tensor, c_silu: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shift1, scale1, gate1, shift2, scale2, gate2 = _dense(self.adaLN_modulation[1], c_silu, dtype).chunk(6, dim=1)
        x = x + gate1[:, None] * self.attn(layer_norm_modulate(x, scale1, shift1, dtype=dtype), dtype)
        return x + gate2[:, None] * self.mlp(layer_norm_modulate(x, scale2, shift2, dtype=dtype), dtype)


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(hidden_size, patch_size * patch_size * out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size))

    def forward(self, x: torch.Tensor, c_silu: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shift, scale = _dense(self.adaLN_modulation[1], c_silu, dtype).chunk(2, dim=1)
        return _dense(self.linear, layer_norm_modulate(x, scale, shift, dtype=dtype), dtype)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden_size: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, H, W, C) → (B, T, hidden): the stride-p conv as one dense layer over
        the patches flattened in the conv weight's (C, p, p) order."""
        b, h, w, c = x.shape
        p = self.patch_size
        patches = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4).reshape(b, -1, c * p * p)
        weight = self.proj.weight.reshape(self.proj.out_channels, -1)
        return F.linear(patches.to(dtype), weight.to(dtype), self.proj.bias.to(dtype))


class DiT(nn.Module):
    """Config-compatible DiT: ``forward(t, x_nhwc, y=None, generator=None) → (B, H, W, out_channels)``.

    ``dim`` (C, H, W) gives the input channels and the tile size the
    positions are made for; ``patch_size`` must divide H and W. The
    parameters are made on ``device`` (``None`` → the CUDA card)."""

    def __init__(
        self,
        dim: Sequence[int] = (3, 512, 512),
        patch_size: int = 16,
        hidden_size: int = 1152,
        depth: int = 28,
        num_heads: int = 16,
        mlp_ratio: float = 4.0,
        out_channels: Optional[int] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        channels, height, width = (int(v) for v in dim)
        if height != width or height % patch_size:
            raise ValueError(f"DiT takes square tiles whose side the patch size divides, "
                             f"got {tuple(dim)} / {patch_size}")
        device = resolve_device(device)
        self.dim = (channels, height, width)
        self.patch_size = int(patch_size)
        self.out_channels = int(out_channels or channels)
        self.depth = int(depth)
        self.dtype = torch.float32  # the compute type; the trainer sets bfloat16 under bf16-mixed
        with torch.device(device):  # built where it runs: torch's default draws of 675 M values take seconds on a CPU
            self.x_embedder = PatchEmbed(channels, hidden_size, patch_size)
            self.t_embedder = TimestepEmbedder(hidden_size)
            self.blocks = nn.ModuleList([DiTBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth)])
            self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels)
        pos = sincos_pos_embed(hidden_size, height // patch_size)[None].to(device)
        self.register_buffer("pos_embed", pos, persistent=False)
        self.initialize_weights()

    @torch.no_grad()
    def initialize_weights(self) -> None:
        """DiT's ``initialize_weights``, where the weights lie."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)
        w = self.x_embedder.proj.weight
        nn.init.xavier_uniform_(w.view(w.shape[0], -1))
        nn.init.zeros_(self.x_embedder.proj.bias)
        nn.init.normal_(self.t_embedder.mlp[0].weight, std=0.02)
        nn.init.normal_(self.t_embedder.mlp[2].weight, std=0.02)
        for layer in [b.adaLN_modulation[1] for b in self.blocks] + [self.final_layer.adaLN_modulation[1],
                                                                      self.final_layer.linear]:
            nn.init.zeros_(layer.weight)
            nn.init.zeros_(layer.bias)

    def forward(
        self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """t: () or (B,) in [0, 1]; x: (B, H, W, C) NHWC. ``y`` and ``generator``
        are taken for the calling convention; the net has no labels and no dropout."""
        dtype = self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        b, h, w, _ = x.shape
        p = self.patch_size
        with _span("dit.embed"):
            tokens = self.x_embedder(x, dtype) + self.pos_embed  # the residual stream in f32
            c_silu = F.silu(self.t_embedder(t, dtype))
        with _span("dit.blocks", blocks=self.depth, tokens=tokens.shape[1]):
            for block in self.blocks:
                tokens = block(tokens, c_silu, dtype)
        with _span("dit.final"):
            out = self.final_layer(tokens, c_silu, dtype).reshape(b, h // p, w // p, p, p, self.out_channels)
            return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, self.out_channels).to(torch.float32)


__all__ = ["DiT", "DiTBlock", "sincos_pos_embed"]

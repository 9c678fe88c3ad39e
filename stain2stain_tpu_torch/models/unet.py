"""ADM-style UNet velocity network (counterpart of ``stain2stain_tpu/models/unet.py``).

Same architecture and numerics as the flax ``UNetModel``:

- timestep embedding → 2-layer SiLU MLP (model_channels → 4·model_channels),
  plus an optional class embedding (``class_cond``)
- residual blocks: GN → SiLU → 3×3 conv, FiLM time conditioning
  (``use_scale_shift_norm``: h = norm(h)·(1+scale)+shift), dropout
  (:class:`..ops.dropout.FastDropout`, active in training mode only), zero-init
  out conv
- self-attention at the configured feature resolutions and in the middle
  block, ``num_head_channels`` per head, through :mod:`..ops.attention`
  (kernel K1 on the card)
- down path: stride-2 conv; up path: nearest ×2 + conv; skip concatenation

The public layout is the JAX package's: ``forward(t, x)`` takes and returns
NHWC (B, H, W, C); inside, the net runs NCHW. ``dtype`` is the compute type:
parameters stay f32 and each conv/linear casts its input and weights to it,
the output is f32. In training mode (``net.train()``) gradients flow through
the attention kernels' ``autograd.Function``, the norms' memory-lean
backwards and the dropout; each dropout layer draws its seed from the
``generator`` passed to ``forward``.

``state_dict()`` keeps the torchcfm ``UNetModel`` key layout (``time_embed``,
``input_blocks``, ``middle_block``, ``output_blocks``, ``out``) and its
legacy qkv row order (``[h0·(q,k,v), h1·(q,k,v), …]``), so reference
Lightning checkpoints load directly once their ``net.`` prefix is stripped
(:func:`stain2stain_tpu_torch.compat.load_reference_checkpoint`).

Not in this slice: ``fused_conv`` and ``s2b_conv`` (opt-in conv paths) and
``use_checkpoint`` (training rematerialization) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .._device import DeviceLike, resolve_device
from ..ops.attention import attention
from ..ops.dropout import FastDropout
from ..ops.norms import group_norm, group_norm_film_silu, group_norm_silu
from ..ops.time_embedding import timestep_embedding_adm

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def _gn_groups(channels: int) -> int:
    """Largest group count ≤ 32 that divides the channels."""
    groups = min(32, channels)
    while channels % groups:
        groups -= 1
    return groups


def attention_ds(attention_resolutions: Any, image_size: int) -> tuple:
    """Downsample ratios that attend: a "16,8" string of feature-map sizes
    (ADM convention, ratio = image_size // size) or explicit ratios."""
    if isinstance(attention_resolutions, str):
        return tuple(image_size // int(r) for r in attention_resolutions.split(",") if r.strip())
    return tuple(int(r) for r in attention_resolutions)


def _as_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "__name__", None) or str(dtype)
    name = name.rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; options: {sorted(_DTYPES)}")
    return _DTYPES[name]


def _norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_gn_groups(channels), channels, eps=1e-5)


def _conv(module: nn.Module, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Conv2d/Conv1d/Linear applied in the compute dtype (f32 params cast per call)."""
    w = module.weight.to(dtype)
    b = module.bias.to(dtype) if module.bias is not None else None
    h = h.to(dtype)
    if isinstance(module, nn.Conv2d):
        return F.conv2d(h, w, b, stride=module.stride, padding=module.padding)
    if isinstance(module, nn.Conv1d):  # attention qkv/proj: a 1×1 conv = a dense layer
        return F.linear(h, w[:, :, 0], b)
    return F.linear(h, w, b)


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlock(nn.Module):
    """ADM residual block with FiLM time-embedding conditioning (plain path)."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: int,
        dropout: float = 0.0,
        use_scale_shift_norm: bool = True,
        up: bool = False,
        down: bool = False,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(
            _norm(channels), nn.SiLU(), nn.Conv2d(channels, out_channels, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels),
        )
        self.out_layers = nn.Sequential(
            _norm(out_channels),
            nn.SiLU(),
            FastDropout(dropout),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
        )
        nn.init.zeros_(self.out_layers[3].weight)
        nn.init.zeros_(self.out_layers[3].bias)
        self.skip_connection = (
            nn.Conv2d(channels, out_channels, 1) if channels != out_channels else nn.Identity()
        )

    def forward(
        self, x: torch.Tensor, emb: torch.Tensor, dtype: torch.dtype,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        norm_in = self.in_layers[0]
        h = group_norm_silu(x, norm_in.weight, norm_in.bias, norm_in.num_groups).to(dtype)
        if self.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = _conv(self.in_layers[2], h, dtype)

        emb_out = _conv(self.emb_layers[1], F.silu(emb.to(dtype)), dtype)[:, :, None, None]
        norm_out = self.out_layers[0]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = group_norm_film_silu(h, norm_out.weight, norm_out.bias, scale, shift, norm_out.num_groups)
        else:
            h = group_norm_silu(h + emb_out, norm_out.weight, norm_out.bias, norm_out.num_groups)
        h = self.out_layers[2](h.to(dtype), generator)  # dropout: the identity in eval mode
        h = _conv(self.out_layers[3], h, dtype)

        if isinstance(self.skip_connection, nn.Conv2d):
            x = _conv(self.skip_connection, x, dtype)
        return (x + h).to(dtype)


class AttentionBlock(nn.Module):
    """Spatial self-attention over the (H·W) token grid, residual.

    ``qkv``/``proj_out`` are 1×1 Conv1d weights in torchcfm's layout with the
    legacy qkv row order; total scaling is 1/√d.
    """

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        if channels % num_heads:
            raise ValueError(
                f"attention channels {channels} not divisible by num_heads={num_heads}"
            )
        self.num_heads = num_heads
        self.norm = _norm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, c, height, width = x.shape
        heads, d = self.num_heads, c // self.num_heads
        h = group_norm(x, self.norm.weight, self.norm.bias, self.norm.num_groups).to(dtype)
        h = h.reshape(b, c, height * width).transpose(1, 2)  # (B, T, C)
        qkv = _conv(self.qkv, h, dtype).reshape(b, height * width, heads, 3, d)
        q, k, v = qkv.unbind(dim=3)  # legacy order: rows grouped per head
        out = attention(q, k, v, d).reshape(b, height * width, c).to(dtype)
        out = _conv(self.proj_out, out, dtype)
        return x + out.transpose(1, 2).reshape(b, c, height, width)


class Downsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1) if use_conv else nn.AvgPool2d(2)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(self.op, nn.Conv2d):
            return _conv(self.op, x, dtype)
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1) if use_conv else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = _upsample_nearest(x)
        return _conv(self.conv, x, dtype) if self.conv is not None else x


class UNetModel(nn.Module):
    """Config-compatible ADM UNet: ``forward(t, x_nhwc, y=None) → (B, H, W, C_out)``.

    Constructor keys match ``configs/model/*.yaml`` (``dim``, ``num_channels``,
    ``attention_resolutions`` as a "16,8" string of feature sizes, …). The
    parameters are made on ``device`` (``None`` → the CUDA card).
    """

    def __init__(
        self,
        dim: Sequence[int] = (3, 256, 256),
        num_channels: int = 128,
        num_res_blocks: int = 2,
        channel_mult: Sequence[int] = (1, 2, 2, 4),
        attention_resolutions: Any = "16",
        dropout: float = 0.0,
        num_heads: int = 4,
        num_head_channels: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = False,
        class_cond: bool = False,
        num_classes: Optional[int] = None,
        out_channels: Optional[int] = None,
        conv_resample: bool = True,
        use_checkpoint: Any = False,
        fused_attention: Optional[bool] = None,
        fused_conv: Optional[bool] = None,
        s2b_conv: Optional[int] = None,
        dtype: Any = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        if fused_conv:
            raise NotImplementedError("fused_conv=True (kernels K2-K5) is not ported yet")
        if s2b_conv:
            raise NotImplementedError("s2b_conv is not ported yet")
        if use_checkpoint:
            raise NotImplementedError("use_checkpoint (training remat) is not ported yet")
        if fused_attention is False:
            raise NotImplementedError(
                "fused_attention=False is not a path of the port: CUDA tensors always "
                "go through kernel K1, CPU tensors through its plain version"
            )
        if class_cond and num_classes is None:
            raise ValueError("class_cond=True requires num_classes")
        device = resolve_device(device)
        self.dim = tuple(dim)
        self.num_channels = num_channels
        self.num_res_blocks = num_res_blocks
        self.channel_mult = tuple(channel_mult)
        self.class_cond = class_cond
        self.num_classes = num_classes
        self.dropout = dropout
        self.dtype = _as_dtype(dtype)

        mc = num_channels
        time_dim = 4 * mc
        in_ch = self.dim[0]
        image_size = self.dim[-1]
        attn_ds = attention_ds(attention_resolutions, image_size)

        def heads_for(ch: int) -> int:
            if num_head_channels != -1:
                return max(ch // num_head_channels, 1)
            return num_heads

        res_kw = dict(dropout=dropout, use_scale_shift_norm=use_scale_shift_norm)
        self.time_embed = nn.Sequential(nn.Linear(mc, time_dim), nn.SiLU(), nn.Linear(time_dim, time_dim))
        if class_cond:
            self.label_emb = nn.Embedding(num_classes, time_dim)

        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(in_ch, mc, 3, padding=1)])])
        ch, ds = mc, 1
        skip_chs = [mc]
        level_cfg = []
        n_levels = len(self.channel_mult)
        for level, mult in enumerate(self.channel_mult):
            out_ch = mult * mc
            heads = heads_for(out_ch) if ds in attn_ds else 0
            level_cfg.append((level, out_ch, heads))
            for _ in range(num_res_blocks):
                mods = [ResBlock(ch, time_dim, out_ch, **res_kw)]
                ch = out_ch
                if heads:
                    mods.append(AttentionBlock(ch, heads))
                self.input_blocks.append(nn.ModuleList(mods))
                skip_chs.append(ch)
            if level != n_levels - 1:
                if resblock_updown:
                    down = ResBlock(ch, time_dim, ch, down=True, **res_kw)
                else:
                    down = Downsample(ch, conv_resample)
                self.input_blocks.append(nn.ModuleList([down]))
                skip_chs.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList(
            [
                ResBlock(ch, time_dim, ch, **res_kw),
                AttentionBlock(ch, heads_for(ch)),
                ResBlock(ch, time_dim, ch, **res_kw),
            ]
        )

        self.output_blocks = nn.ModuleList()
        for level, out_ch, heads in reversed(level_cfg):
            for i in range(num_res_blocks + 1):
                mods = [ResBlock(ch + skip_chs.pop(), time_dim, out_ch, **res_kw)]
                ch = out_ch
                if heads:
                    mods.append(AttentionBlock(ch, heads))
                if i == num_res_blocks and level != 0:
                    if resblock_updown:
                        mods.append(ResBlock(ch, time_dim, ch, up=True, **res_kw))
                    else:
                        mods.append(Upsample(ch, conv_resample))
                self.output_blocks.append(nn.ModuleList(mods))
        assert not skip_chs, "skip bookkeeping mismatch"

        self.out = nn.Sequential(
            _norm(ch),
            nn.SiLU(),
            nn.Conv2d(ch, out_channels if out_channels is not None else in_ch, 3, padding=1),
        )
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)
        self.to(device)

    def _block(self, mods: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor, generator) -> torch.Tensor:
        for m in mods:
            if isinstance(m, ResBlock):
                h = m(h, emb, self.dtype, generator)
            elif isinstance(m, nn.Conv2d):  # the stem
                h = _conv(m, h, self.dtype)
            else:
                h = m(h, self.dtype)
        return h

    def forward(
        self, t: torch.Tensor, x: torch.Tensor, y: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """t: () or (B,) in [0,1]; x: (B, H, W, C) NHWC; y: (B,) int labels;
        ``generator``: the dropout seeds' source in training mode (torch's
        default generator if None)."""
        dtype = self.dtype
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        emb = timestep_embedding_adm(t, self.num_channels)
        emb = _conv(self.time_embed[0], emb, dtype)
        emb = _conv(self.time_embed[2], F.silu(emb), dtype)
        if self.class_cond:
            if y is None:
                raise ValueError("class-conditional UNet called without labels y")
            emb = emb + self.label_emb(y).to(dtype)

        h = x.permute(0, 3, 1, 2).contiguous()
        skips = []
        for mods in self.input_blocks:
            h = self._block(mods, h, emb, generator)
            skips.append(h)
        h = self._block(self.middle_block, h, emb, generator)
        for mods in self.output_blocks:
            h = self._block(mods, torch.cat([h, skips.pop()], dim=1), emb, generator)

        norm = self.out[0]
        h = group_norm_silu(h, norm.weight, norm.bias, norm.num_groups).to(dtype)
        h = _conv(self.out[2], h, dtype)
        return h.to(torch.float32).permute(0, 2, 3, 1)


__all__ = ["UNetModel", "ResBlock", "AttentionBlock", "Downsample", "Upsample"]

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

``fused_conv=True`` runs each ResBlock that meets the gate of JAX
``unet.py:148-165`` (bf16 compute, no up/down, ``use_scale_shift_norm``, both
convs :func:`..ops.conv.supported`) through :func:`..ops.conv.norm_act_conv`:
GroupNorm → (FiLM) → SiLU → dropout → 3×3 conv as kernel K2 forward and
K3–K5 backward on the card, their plain versions on the CPU. The gate is read
at each call, since the trainer sets ``dtype`` after construction. The block
permutes to NHWC at its boundary and returns an NCHW view of NHWC memory, so
consecutive fused blocks pass NHWC memory without a transpose. State-dict
keys do not change.

``use_checkpoint`` rematerializes activations in the backward (JAX
``unet.py:547-653``): False stores everything; True or "block" remats each
res/attn unit; "level" remats whole resolution levels; "block:K"/"level:K"
remat only the K shallowest levels and store the deeper ones and the mid
block. Regions run through ``torch.utils.checkpoint`` (non-reentrant), only in
training mode with grad enabled, so eval, ``generate`` and ``no_grad``
callers see no change. Over the torchcfm layout the regions are JAX's:

- down level L: its ``input_blocks`` units (ResBlock + attention) and, inside
  the region, the downsample that ends the level, so the stored output is
  the small tensor. Under "block" each unit is a region and a conv/pool
  downsample is not rematted (a ``resblock_updown`` down ResBlock is);
- the mid block, one region, only when no depth is given;
- up level L: the upsample that ends level L+1's last output block (it
  starts level L's region, so the stored input is the low-resolution
  tensor), then level L's output blocks, each with its skip concat inside
  the region, so the double-width tensor is recomputed, not stored. Under
  "block" each (concat + ResBlock + attention) unit is a region.

Every dropout seed is drawn from the ``generator`` once, in forward order,
before any region, and handed to its ResBlock: a recompute reuses it, and the
generator's state after a step is the same with and without remat.

``s2b_conv=f`` (opt-in) runs a ResBlock's two 3×3 convs through
:func:`..ops.s2b_conv.space_to_batch_conv` (f × f halo tiles, one VALID
cuDNN conv over the B·f² tiles) where JAX ``ResBlock._s2b_factor``
(``unet.py:167-176``) allows: not in up/down blocks, only where f divides H
and W and a tile keeps at least 16 px a side. The fused path goes first.
State-dict keys do not change.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import DeviceLike, resolve_device
from ..ops import conv as conv_ops
from ..ops.attention import attention
from ..ops.dropout import FastDropout, draw_seed
from ..ops.norms import group_norm, group_norm_film_silu, group_norm_silu
from ..ops.s2b_conv import space_to_batch_conv
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


def remat_mode(use_checkpoint: Any) -> tuple[Optional[str], Optional[int]]:
    """(mode, depth) of a ``use_checkpoint`` value, as JAX ``_remat_mode``
    (``unet.py:596-617``): mode None, "block" or "level"; depth None (every
    level and the mid block) or K (the K shallowest levels only)."""
    if use_checkpoint is True:
        return "block", None
    if not use_checkpoint:
        return None, None
    mode = str(use_checkpoint)
    depth: Optional[int] = None
    if ":" in mode:
        mode, _, d = mode.partition(":")
        depth = int(d)
    if mode not in ("block", "level"):
        raise ValueError(
            "use_checkpoint must be False/True/'block'/'level' (optionally "
            f"'block:K'/'level:K' for the K shallowest levels), got {mode!r}"
        )
    return mode, depth


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
        fused_conv: bool = False,
        s2b_conv: Optional[int] = None,
    ):
        super().__init__()
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.fused_conv = bool(fused_conv)
        self.s2b_conv = int(s2b_conv or 0)
        self.out_channels = out_channels
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

    def fused_enabled(self, x: torch.Tensor, dtype: torch.dtype) -> bool:
        """The gate of JAX ``ResBlock._fused_enabled`` (``unet.py:148-165``)
        without its backend test, for NCHW ``x``."""
        if not self.fused_conv or self.up or self.down or not self.use_scale_shift_norm:
            return False
        if dtype != torch.bfloat16 or self.out_layers[2].rate >= 1.0:
            return False
        b, c, h, w = x.shape
        d = self.out_channels
        return conv_ops.supported((b, h, w, c), (3, 3, c, d)) and conv_ops.supported((b, h, w, d), (3, 3, d, d))

    def _s2b_factor(self, h: torch.Tensor) -> int:
        """The tile factor for NCHW ``h``, or 0 for the plain conv (JAX
        ``_s2b_factor``): tiles under 16 px pay more halo than they gain."""
        f = self.s2b_conv
        if f < 2 or self.up or self.down:
            return 0
        height, width = h.shape[2], h.shape[3]
        if height % f or width % f or min(height, width) // f < 16:
            return 0
        return f

    def _conv3(self, conv: nn.Conv2d, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        f = self._s2b_factor(h)
        if not f:
            return _conv(conv, h, dtype)
        y = space_to_batch_conv(h.to(dtype), conv.weight.to(dtype), f)
        return y + conv.bias.to(dtype)[None, :, None, None]

    def _fused_forward(self, x, emb, dtype, seed) -> torch.Tensor:
        """JAX ``ResBlock._fused_call`` (``unet.py:236-269``) on NCHW ``x``."""
        norm_in, conv_in = self.in_layers[0], self.in_layers[2]
        norm_out, dropout, conv_out = self.out_layers[0], self.out_layers[2], self.out_layers[3]
        h = conv_ops.norm_act_conv(
            x.permute(0, 2, 3, 1), conv_in.weight.permute(2, 3, 1, 0), conv_in.bias,
            norm_in.weight, norm_in.bias, groups=norm_in.num_groups, act="silu",
        )
        emb_out = _conv(self.emb_layers[1], F.silu(emb.to(dtype)), dtype)
        film_scale, film_shift = torch.chunk(emb_out.to(torch.float32), 2, dim=1)
        # the seed is the unfused FastDropout's, so one generator gives both
        # paths the same mask
        rate = dropout.rate if dropout.active() else 0.0
        h = conv_ops.norm_act_conv(
            h, conv_out.weight.permute(2, 3, 1, 0), conv_out.bias, norm_out.weight, norm_out.bias,
            film_scale=film_scale, film_shift=film_shift, groups=norm_out.num_groups, act="silu",
            dropout_rate=rate, seed=seed if rate else None,
        )
        if isinstance(self.skip_connection, nn.Conv2d):
            x = _conv(self.skip_connection, x, dtype)
        return (h.permute(0, 3, 1, 2) + x).to(dtype)

    def forward(
        self, x: torch.Tensor, emb: torch.Tensor, dtype: torch.dtype,
        generator: Optional[torch.Generator] = None, seed: Optional[int] = None,
    ) -> torch.Tensor:
        """``seed``: the dropout seed drawn ahead; None draws it from ``generator``
        when the dropout is active (training mode, 0 < rate < 1)."""
        if seed is None and self.out_layers[2].active():
            seed = draw_seed(generator)
        if self.fused_enabled(x, dtype):
            return self._fused_forward(x, emb, dtype, seed)
        norm_in = self.in_layers[0]
        h = group_norm_silu(x, norm_in.weight, norm_in.bias, norm_in.num_groups).to(dtype)
        if self.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self._conv3(self.in_layers[2], h, dtype)

        emb_out = _conv(self.emb_layers[1], F.silu(emb.to(dtype)), dtype)[:, :, None, None]
        norm_out = self.out_layers[0]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = group_norm_film_silu(h, norm_out.weight, norm_out.bias, scale, shift, norm_out.num_groups)
        else:
            h = group_norm_silu(h + emb_out, norm_out.weight, norm_out.bias, norm_out.num_groups)
        h = self.out_layers[2](h.to(dtype), seed=seed)  # dropout: the identity in eval mode
        h = self._conv3(self.out_layers[3], h, dtype)

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
        self.remat = remat_mode(use_checkpoint)
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

        res_kw = dict(dropout=dropout, use_scale_shift_norm=use_scale_shift_norm, fused_conv=bool(fused_conv),
                      s2b_conv=s2b_conv)
        self.time_embed = nn.Sequential(nn.Linear(mc, time_dim), nn.SiLU(), nn.Linear(time_dim, time_dim))
        if class_cond:
            self.label_emb = nn.Embedding(num_classes, time_dim)

        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(in_ch, mc, 3, padding=1)])])
        ch, ds = mc, 1
        skip_chs = [mc]
        level_cfg = []
        n_levels = len(self.channel_mult)
        # the remat regions over the torchcfm layout (module docstring): per
        # level, its units' input_blocks indices and its downsample's, if any
        self._down_levels: list[tuple[int, list[int], Optional[int]]] = []
        for level, mult in enumerate(self.channel_mult):
            out_ch = mult * mc
            heads = heads_for(out_ch) if ds in attn_ds else 0
            level_cfg.append((level, out_ch, heads))
            units = []
            for _ in range(num_res_blocks):
                mods = [ResBlock(ch, time_dim, out_ch, **res_kw)]
                ch = out_ch
                if heads:
                    mods.append(AttentionBlock(ch, heads))
                units.append(len(self.input_blocks))
                self.input_blocks.append(nn.ModuleList(mods))
                skip_chs.append(ch)
            down_index = None
            if level != n_levels - 1:
                if resblock_updown:
                    down = ResBlock(ch, time_dim, ch, down=True, **res_kw)
                else:
                    down = Downsample(ch, conv_resample)
                down_index = len(self.input_blocks)
                self.input_blocks.append(nn.ModuleList([down]))
                skip_chs.append(ch)
                ds *= 2
            self._down_levels.append((level, units, down_index))

        self.middle_block = nn.ModuleList(
            [
                ResBlock(ch, time_dim, ch, **res_kw),
                AttentionBlock(ch, heads_for(ch)),
                ResBlock(ch, time_dim, ch, **res_kw),
            ]
        )

        self.output_blocks = nn.ModuleList()
        # per level (deepest first) its output_blocks indices; the upsample
        # that ends a level's last block in this layout starts the next level
        self._up_levels: list[tuple[int, list[int]]] = []
        for level, out_ch, heads in reversed(level_cfg):
            first = len(self.output_blocks)
            self._up_levels.append((level, list(range(first, first + num_res_blocks + 1))))
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

        self.out_channels = out_channels if out_channels is not None else in_ch
        self.out = nn.Sequential(_norm(ch), nn.SiLU(), nn.Conv2d(ch, self.out_channels, 3, padding=1))
        nn.init.zeros_(self.out[2].weight)
        nn.init.zeros_(self.out[2].bias)
        # every ResBlock's slot in the seeds drawn ahead: forward order is
        # registration order
        self._resblocks = [m for m in self.modules() if isinstance(m, ResBlock)]
        for i, block in enumerate(self._resblocks):
            block.seed_slot = i
        self.to(device)

    def _run(self, mods, h: torch.Tensor, emb: torch.Tensor, seeds: Optional[list]) -> torch.Tensor:
        for m in mods:
            if isinstance(m, ResBlock):
                h = m(h, emb, self.dtype, seed=seeds[m.seed_slot] if seeds else None)
            elif isinstance(m, nn.Conv2d):  # the stem
                h = _conv(m, h, self.dtype)
            else:
                h = m(h, self.dtype)
        return h

    @staticmethod
    def _region(remat: bool, fn, *args):
        """``fn(*args)``, rematerialized in the backward when ``remat``. Every
        random draw of a region (the dropout seeds) is made before it, so the
        recompute needs no RNG state."""
        if not remat:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    @staticmethod
    def _level_mode(mode: Optional[str], depth: Optional[int], level: int) -> Optional[str]:
        return None if mode is None or (depth is not None and level >= depth) else mode

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

        # every dropout seed, in forward order, before any remat region: a
        # recompute then reuses them, and the generator advances once
        seeds = [draw_seed(generator) for _ in self._resblocks] if self._resblocks[0].out_layers[2].active() else None
        mode, depth = self.remat if (self.training and torch.is_grad_enabled()) else (None, None)
        run = self._run

        h = run(self.input_blocks[0], x.permute(0, 3, 1, 2).contiguous(), emb, seeds)
        skips = [h]
        for level, units, down_index in self._down_levels:
            lm = self._level_mode(mode, depth, level)

            def down_level(h, emb, units=units, down_index=down_index, block=lm == "block"):
                outs = []
                for i in units:
                    h = self._region(block, run, self.input_blocks[i], h, emb, seeds)
                    outs.append(h)
                if down_index is not None:  # inside the level: its stored output is the small tensor
                    mods = self.input_blocks[down_index]
                    h = self._region(block and isinstance(mods[0], ResBlock), run, mods, h, emb, seeds)
                    outs.append(h)
                return tuple(outs)

            outs = self._region(lm == "level", down_level, h, emb)
            skips.extend(outs)
            h = outs[-1]

        h = self._region(mode is not None and depth is None, run, self.middle_block, h, emb, seeds)

        def up_unit(mods, h, skip, emb):
            # the skip concat inside the region: the double-width tensor is recomputed, not stored
            return run(mods, torch.cat([h, skip], dim=1), emb, seeds)

        resample = None  # the upsample ending the previous (deeper) level's last block
        for level, units in self._up_levels:
            lm = self._level_mode(mode, depth, level)
            tail = self.output_blocks[units[-1]][-1] if level != 0 else None

            def up_level(h, emb, *level_skips, units=units, resample=resample, tail=tail, block=lm == "block"):
                if resample is not None:
                    h = self._region(block and isinstance(resample, ResBlock), run, [resample], h, emb, seeds)
                for i, skip in zip(units, level_skips):
                    mods = self.output_blocks[i]
                    if tail is not None and i == units[-1]:
                        mods = mods[:-1]
                    h = self._region(block, up_unit, mods, h, skip, emb)
                return h

            h = self._region(lm == "level", up_level, h, emb, *[skips.pop() for _ in units])
            resample = tail
        assert not skips, "skip bookkeeping mismatch"

        norm = self.out[0]
        h = group_norm_silu(h, norm.weight, norm.bias, norm.num_groups).to(dtype)
        h = _conv(self.out[2], h, dtype)
        return h.to(torch.float32).permute(0, 2, 3, 1)


__all__ = ["UNetModel", "ResBlock", "AttentionBlock", "Downsample", "Upsample", "remat_mode"]

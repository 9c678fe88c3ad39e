"""Weights across the two packages (counterpart of ``stain2stain_tpu/compat/torch_unet.py``).

- :func:`unet_state_dict_from_flax` takes the JAX package's UNet parameter
  tree as nested numpy dicts (what ``jax.device_get(variables["params"])``
  gives) and returns the port's ``state_dict``. It is the exact inverse of
  ``stain2stain_tpu.compat.convert_unet_state_dict``: flax conv kernels
  ``(kh, kw, I, O)`` → ``(O, I, kh, kw)``, Dense ``(I, O)`` → Linear
  ``(O, I)`` (or Conv1d ``(O, I, 1)`` for the attention qkv/proj), GN
  ``scale/bias`` → ``weight/bias``, and the attention qkv rows put back into
  the legacy ``[h0·(q,k,v), h1·(q,k,v), …]`` order.
- :func:`unet_4to3_state_dict_from_flax` does the same for the mask-conditioned
  ``UNet4to3`` (the flax tree nests the UNet under ``unet``, the port's keys
  under ``unet.``); :func:`frac_head_state_dict_from_flax` gives the
  aux-fraction task's head (flax ``kernel`` (C, 1) → ``weight`` (1, C)).
- :func:`load_reference_checkpoint` reads a ``.pt`` state dict or a reference
  Lightning ``.ckpt`` (``torch.load(weights_only=True)``) and strips the
  ``net.`` prefix, giving a state dict the port's UNet loads directly.
- :func:`convert_lightning_state_dict` / :func:`convert_unet_state_dict`
  (counterparts of ``stain2stain_tpu.compat``'s, for
  ``python -m stain2stain_tpu_torch.convert_ckpt``): the reference keys are
  the port's, so they strip the prefix and, for a net trained with
  ``use_new_attention_order=True`` (``attention_order="new"``, rows
  ``[q‖k‖v]``), put the qkv rows back into the legacy order, the inverse of
  JAX ``torch_unet.py::_qkv_perm``. :func:`load_strict` loads a state dict
  and raises :class:`ConversionError` naming a missing or unexpected key.

Orbax checkpoints of the JAX package cannot be read without JAX;
``scripts/torch_from_orbax.py`` converts them in a process that has JAX.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..models.unet import attention_ds

__all__ = [
    "ConversionError",
    "convert_lightning_state_dict",
    "convert_unet_state_dict",
    "load_strict",
    "unet_state_dict_from_flax",
    "unet_4to3_state_dict_from_flax",
    "frac_head_state_dict_from_flax",
    "load_reference_checkpoint",
]


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _conv(p: Mapping) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1)), "bias": _t(p["bias"])}


def _conv1d(kernel: np.ndarray, bias: np.ndarray) -> dict:
    return {"weight": _t(np.asarray(kernel).T[:, :, None]), "bias": _t(bias)}


def _linear(p: Mapping) -> dict:
    return {"weight": _t(np.asarray(p["kernel"]).T), "bias": _t(p["bias"])}


def _norm(p: Mapping) -> dict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _put(sd: dict, prefix: str, tensors: dict) -> None:
    for name, value in tensors.items():
        sd[f"{prefix}.{name}"] = value


def _resblock(sd: dict, prefix: str, p: Mapping) -> None:
    _put(sd, f"{prefix}.in_layers.0", _norm(p["norm_in"]))
    _put(sd, f"{prefix}.in_layers.2", _conv(p["conv_in"]))
    _put(sd, f"{prefix}.emb_layers.1", _linear(p["emb_proj"]))
    _put(sd, f"{prefix}.out_layers.0", _norm(p["norm_out"]))
    _put(sd, f"{prefix}.out_layers.3", _conv(p["conv_out"]))
    if "skip_proj" in p:
        _put(sd, f"{prefix}.skip_connection", _conv(p["skip_proj"]))


def _qkv_perm(channels: int, head_dim: int) -> np.ndarray:
    """Legacy row of each ``[q‖k‖v]`` column (``torch_unet.py::_qkv_perm``)."""
    cols = np.arange(3 * channels)
    comp, rem = cols // channels, cols % channels
    head, idx = rem // head_dim, rem % head_dim
    return head * 3 * head_dim + comp * head_dim + idx


def _attention(sd: dict, prefix: str, p: Mapping, channels: int, num_heads: int) -> None:
    kernel = np.asarray(p["qkv"]["kernel"])  # (C, 3C), columns [q‖k‖v]
    bias = np.asarray(p["qkv"]["bias"])
    perm = _qkv_perm(channels, channels // num_heads)
    w_rows = np.empty_like(kernel.T)
    b_rows = np.empty_like(bias)
    w_rows[perm] = kernel.T  # the inverse of torch_unet's `qkv_w[perm]`
    b_rows[perm] = bias
    _put(sd, f"{prefix}.norm", _norm(p["norm"]))
    _put(sd, f"{prefix}.qkv", _conv1d(w_rows.T, b_rows))
    proj = p["proj"]
    _put(sd, f"{prefix}.proj_out", _conv1d(proj["kernel"], proj["bias"]))


def unet_state_dict_from_flax(
    params: Mapping[str, Any],
    *,
    image_size: int,
    num_channels: int,
    num_res_blocks: int,
    channel_mult: Sequence[int] = (1, 2, 2, 4),
    attention_resolutions: Any = "16",
    num_heads: int = 4,
    num_head_channels: int = -1,
    class_cond: bool = False,
) -> dict[str, torch.Tensor]:
    """The port's UNet ``state_dict`` from the JAX package's UNet params."""
    mc = num_channels
    attn_ds = attention_ds(attention_resolutions, image_size)

    def heads_for(ch: int) -> int:
        if num_head_channels != -1:
            return max(ch // num_head_channels, 1)
        return num_heads

    sd: dict[str, torch.Tensor] = {}
    _put(sd, "time_embed.0", _linear(params["time_dense_0"]))
    _put(sd, "time_embed.2", _linear(params["time_dense_1"]))
    if class_cond:
        sd["label_emb.weight"] = _t(params["label_emb"]["embedding"])
    _put(sd, "input_blocks.0.0", _conv(params["conv_stem"]))

    n_levels = len(channel_mult)
    ds, idx = 1, 1
    level_cfg = []
    for level, mult in enumerate(channel_mult):
        ch = mult * mc
        heads = heads_for(ch) if ds in attn_ds else 0
        level_cfg.append((level, ch, heads))
        down = params[f"down_{level}"]
        for i in range(num_res_blocks):
            block = down[f"block_{i}"]
            _resblock(sd, f"input_blocks.{idx}.0", block["res"])
            if heads:
                _attention(sd, f"input_blocks.{idx}.1", block["attn"], ch, heads)
            idx += 1
        if level != n_levels - 1:
            if "down" in down:
                d = down["down"]
                if "Conv_0" in d:
                    _put(sd, f"input_blocks.{idx}.0.op", _conv(d["Conv_0"]))
                else:  # resblock_updown
                    _resblock(sd, f"input_blocks.{idx}.0", d)
            idx += 1
            ds *= 2

    mid_ch = channel_mult[-1] * mc
    mid = params["mid"]
    _resblock(sd, "middle_block.0", mid["res_0"])
    _attention(sd, "middle_block.1", mid["attn"], mid_ch, heads_for(mid_ch))
    _resblock(sd, "middle_block.2", mid["res_1"])

    idx = 0
    for level, ch, heads in reversed(level_cfg):
        up = params[f"up_{level}"]
        for i in range(num_res_blocks + 1):
            block = up[f"block_{i}"]
            _resblock(sd, f"output_blocks.{idx}.0", block["res"])
            sub = 1
            if heads:
                _attention(sd, f"output_blocks.{idx}.{sub}", block["attn"], ch, heads)
                sub += 1
            if i == num_res_blocks and level != 0:
                # the flax net runs this upsample at the start of the next level up
                target = params[f"up_{level - 1}"].get("up")
                if target is not None:
                    if "Conv_0" in target:
                        _put(sd, f"output_blocks.{idx}.{sub}.conv", _conv(target["Conv_0"]))
                    else:  # resblock_updown
                        _resblock(sd, f"output_blocks.{idx}.{sub}", target)
            idx += 1

    norm = params["norm_final"]
    _put(sd, "out.0", _norm(norm))
    _put(sd, "out.2", _conv(params["conv_out"]))
    return sd


def unet_4to3_state_dict_from_flax(
    params: Mapping[str, Any],
    *,
    image_size: int,
    num_channels: int,
    num_res_blocks: int,
    channel_mult: Sequence[int] = (1, 2, 2, 4),
    attention_resolutions: Any = (16, 8),
    num_heads: int = 4,
    num_head_channels: int = -1,
) -> dict[str, torch.Tensor]:
    """The port's ``UNet4to3`` ``state_dict`` from the JAX package's ``UNet4to3`` params."""
    inner = unet_state_dict_from_flax(
        params["unet"], image_size=image_size, num_channels=num_channels, num_res_blocks=num_res_blocks,
        channel_mult=channel_mult, attention_resolutions=attention_resolutions, num_heads=num_heads,
        num_head_channels=num_head_channels,
    )
    return {f"unet.{k}": v for k, v in inner.items()}


def frac_head_state_dict_from_flax(head: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The aux-fraction head's ``nn.Linear`` state dict from its flax ``{kernel, bias}``."""
    return _linear(head)


def load_reference_checkpoint(path: str | Path, net_prefix: str = "net.") -> dict[str, torch.Tensor]:
    """Read a ``.pt`` state dict or a Lightning ``.ckpt`` into a UNet state dict.

    Lightning checkpoints keep the velocity net under ``state_dict`` with the
    ``net.`` attribute prefix; both the nesting and the prefix are removed.
    Loading uses ``weights_only=True``, so a file holding arbitrary pickled
    objects is refused rather than executed.
    """
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    if not isinstance(obj, Mapping):
        raise ValueError(f"{path}: not a state dict (got {type(obj).__name__})")
    if any(k.startswith(net_prefix) for k in obj):
        obj = {k[len(net_prefix):]: v for k, v in obj.items() if k.startswith(net_prefix)}
    return dict(obj)


class ConversionError(KeyError):
    """A reference checkpoint does not match the architecture it is loaded into."""


def convert_unet_state_dict(
    state_dict: Mapping[str, Any],
    *,
    num_heads: int = 4,
    num_head_channels: int = -1,
    attention_order: str = "legacy",
) -> dict[str, torch.Tensor]:
    """A torchcfm UNet ``state_dict`` (no prefix) in the port's layout: the
    same keys, the qkv rows of every attention layer in the legacy order.

    ``attention_order="new"``: the file's rows are ``[q‖k‖v]`` (each
    head-major); ``"legacy"``: already the port's. The heads of a layer come
    from its channels as in the UNet (``num_head_channels`` per head, else
    ``num_heads``).
    """
    if attention_order not in ("legacy", "new"):
        raise ValueError(f"attention_order must be 'legacy' or 'new', got {attention_order!r}")
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    if attention_order == "legacy":
        return sd
    for key in [k for k in sd if k.endswith(".qkv.weight")]:
        prefix = key[: -len(".weight")]
        channels = sd[key].shape[1]
        heads = max(channels // num_head_channels, 1) if num_head_channels != -1 else num_heads
        perm = torch.from_numpy(_qkv_perm(channels, channels // heads))
        for name in ("weight", "bias"):
            rows = sd[f"{prefix}.{name}"]
            legacy = torch.empty_like(rows)
            legacy[perm] = rows  # row perm[c] of the legacy layout is column c of [q‖k‖v]
            sd[f"{prefix}.{name}"] = legacy
    return sd


def convert_lightning_state_dict(
    state_dict: Mapping[str, Any], net_prefix: str = "net.", **unet_kwargs
) -> dict[str, torch.Tensor]:
    """A reference LightningModule ``state_dict`` (``ckpt["state_dict"]``) →
    the port's UNet ``state_dict``: only the ``net_prefix`` entries, prefix
    stripped, through :func:`convert_unet_state_dict`."""
    net_sd = {k[len(net_prefix):]: v for k, v in state_dict.items() if k.startswith(net_prefix)}
    if not net_sd:
        raise ConversionError(
            f"no '{net_prefix}*' keys in the state dict — not a reference CFM checkpoint, "
            "or pass net_prefix= for a different attribute name"
        )
    return convert_unet_state_dict(net_sd, **unet_kwargs)


def load_strict(module: torch.nn.Module, state_dict: Mapping[str, torch.Tensor]) -> None:
    """``module.load_state_dict(state_dict)`` that raises :class:`ConversionError`
    naming the first missing or unexpected key."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state_dict))
    unexpected = sorted(set(state_dict) - set(own))
    if missing:
        raise ConversionError(
            f"reference checkpoint is missing '{missing[0]}' ({len(missing)} keys) — the model config does not "
            "match the checkpoint's architecture (check num_channels/channel_mult/num_res_blocks/"
            "attention_resolutions)"
        )
    if unexpected:
        raise ConversionError(
            f"reference checkpoint has unexpected key '{unexpected[0]}' ({len(unexpected)} keys) — the model "
            "config does not match the checkpoint's architecture"
        )
    module.load_state_dict(state_dict, strict=True)

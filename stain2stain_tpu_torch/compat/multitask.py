"""Weights of the multitask family across the two packages (counterpart of
``stain2stain_tpu/compat/torch_multitask.py``).

:func:`multitask_state_dict_from_flax` takes the JAX task's merged variables
(``{"params": {"encoder", "flow_decoder", "seg_decoder"}, "batch_stats":
{...}}`` as nested numpy dicts, what ``jax.device_get(variables)`` gives)
and returns the ``state_dict`` of the port's multitask net, whose keys are
the reference Lightning module's (``encoder.inc.double_conv.{0,1,3,4}``,
``encoder.downs.{i}.maxpool_conv.1.double_conv.*``,
``{flow,seg}_decoder.ups.{i}.conv.double_conv.*``,
``flow_decoder.time_mlp.{0,2}``, ``time_proj``, ``outc``). Under
``norm="batch"`` it is the exact inverse of
``stain2stain_tpu.compat.convert_multitask_state_dict`` (BatchNorm ``scale``
/ ``bias`` → ``weight`` / ``bias``, ``batch_stats`` ``mean`` / ``var`` →
``running_mean`` / ``running_var``, ``num_batches_tracked`` 0, which the JAX
converter drops); it also carries GroupNorm parameters, which that converter
does not. A reference checkpoint's ``state_dict`` needs no conversion: it
loads into the port's net under ``norm="batch"`` as it is;
:func:`convert_multitask_state_dict` (the counterpart of JAX's) keeps its
``encoder`` / ``flow_decoder`` / ``seg_decoder`` entries (the flow matcher's
and metrics' buffers of a Lightning file are not the net's).

:func:`segmentation_unet_state_dict_from_flax` does the same for
``SegmentationUNet`` (flax ``enc_{i}`` / ``bottleneck`` / ``dec_{i}`` /
``outc`` → ``encs.{i}`` / ``bottleneck`` / ``decs.{i}.conv`` / ``outc``).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .unet import _conv, _linear, _norm, _put, _t

__all__ = ["convert_multitask_state_dict", "multitask_state_dict_from_flax", "segmentation_unet_state_dict_from_flax"]

_MODULES = ("encoder.", "flow_decoder.", "seg_decoder.")


def convert_multitask_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's multitask net ``state_dict`` from a reference multitask
    ``ckpt["state_dict"]``: its three modules' entries, keys as they are."""
    return {k: torch.as_tensor(v) for k, v in state_dict.items() if k.startswith(_MODULES)}


def _count(tree: Mapping, prefix: str) -> int:
    return sum(1 for k in tree if k.startswith(prefix))


def _double_conv(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    """flax ``DoubleConv`` {conv_i, norm_i/(GroupNorm_0|BatchNorm_0)} → ``<prefix>.double_conv.{0,1,3,4}``."""
    for i, (conv_idx, norm_idx) in enumerate(((0, 1), (3, 4))):
        _put(sd, f"{prefix}.double_conv.{conv_idx}", _conv(params[f"conv_{i}"]))
        norm = params[f"norm_{i}"]
        key = f"{prefix}.double_conv.{norm_idx}"
        if "BatchNorm_0" in norm:
            running = stats[f"norm_{i}"]["BatchNorm_0"]
            _put(sd, key, _norm(norm["BatchNorm_0"]))
            _put(sd, key, {"running_mean": _t(running["mean"]), "running_var": _t(running["var"]),
                           "num_batches_tracked": torch.tensor(0, dtype=torch.int64)})
        else:
            _put(sd, key, _norm(norm["GroupNorm_0"]))


def _decoder(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    if "time_mlp_0" in params:
        _put(sd, f"{prefix}.time_mlp.0", _linear(params["time_mlp_0"]))
        _put(sd, f"{prefix}.time_mlp.2", _linear(params["time_mlp_1"]))
        _put(sd, f"{prefix}.time_proj", _linear(params["time_proj"]))
    for i in range(_count(params, "up_")):
        _double_conv(sd, f"{prefix}.ups.{i}.conv", params[f"up_{i}"]["conv"], stats.get(f"up_{i}", {}).get("conv", {}))
    _put(sd, f"{prefix}.outc", _conv(params["outc"]))


def multitask_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's multitask net ``state_dict`` from the JAX task's merged variables."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    enc, enc_stats = params["encoder"], stats.get("encoder", {})
    _double_conv(sd, "encoder.inc", enc["inc"], enc_stats.get("inc", {}))
    for i in range(_count(enc, "down_")):
        _double_conv(sd, f"encoder.downs.{i}.maxpool_conv.1", enc[f"down_{i}"], enc_stats.get(f"down_{i}", {}))
    for name in ("flow_decoder", "seg_decoder"):
        _decoder(sd, name, params[name], stats.get(name, {}))
    return sd


def segmentation_unet_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``SegmentationUNet`` ``state_dict`` from the JAX module's variables."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for i in range(_count(params, "enc_")):
        _double_conv(sd, f"encs.{i}", params[f"enc_{i}"], stats.get(f"enc_{i}", {}))
    _double_conv(sd, "bottleneck", params["bottleneck"], stats.get("bottleneck", {}))
    for i in range(_count(params, "dec_")):
        _double_conv(sd, f"decs.{i}.conv", params[f"dec_{i}"]["conv"], stats.get(f"dec_{i}", {}).get("conv", {}))
    _put(sd, "outc", _conv(params["outc"]))
    return sd

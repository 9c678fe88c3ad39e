#!/usr/bin/env python3
"""Convert a JAX package (Orbax) checkpoint into a checkpoint directory of the
PyTorch port.

    JAX_PLATFORMS=cpu python scripts/torch_from_orbax.py ckpt_path=<orbax checkpoint dir> \
        +out=<port checkpoint dir> model=<the model config it was trained with> [overrides]

It runs in a process that has JAX (the port itself never imports it): the
checkpoint is restored with ``stain2stain_tpu.training.state.CheckpointIO``,
the task of ``cfg.model`` is built by the port on ``device`` (the CPU unless
``device=cuda``), its weights come from the converter of its family, and
``state.pt`` + ``meta.json`` are written with the port's ``CheckpointIO``:

- the UNet families: ``unet_state_dict_from_flax`` (``UNet4to3``:
  ``unet_4to3_state_dict_from_flax``), and the aux-fraction head through
  ``frac_head_state_dict_from_flax``;
- the multitask families: ``multitask_state_dict_from_flax`` (parameters
  and BatchNorm statistics);
- MNIST's ``SimpleDenseNet``: ``simple_dense_net_state_dict_from_flax``.

Weights only, like ``convert_ckpt``: the optimizer state is a fresh one from
the task's ``configure_optimizers`` (the flattened Adam moments are not
carried); ``step``, ``epoch`` and ``global_step`` are the checkpoint's.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))
os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))

from stain2stain_tpu_torch.config import Config, config_main  # noqa: E402


def port_state_dicts(task, model_cfg: Config, variables: dict) -> tuple[dict, dict]:
    """(net state dict, {head: state dict}) of the port's ``task`` from the
    JAX variables (nested numpy dicts)."""
    from stain2stain_tpu_torch import compat
    from stain2stain_tpu_torch.models import SimpleDenseNet, UNetModel
    from stain2stain_tpu_torch.models.unet_4to3 import UNet4to3
    from stain2stain_tpu_torch.tasks.multitask import MultitaskNet

    params = variables["params"]
    net, net_cfg = task.net, model_cfg.get("net") or {}
    if isinstance(net, MultitaskNet):
        net_sd = compat.multitask_state_dict_from_flax(variables)
    elif isinstance(net, SimpleDenseNet):
        net_sd = compat.simple_dense_net_state_dict_from_flax(params)
    elif isinstance(net, (UNetModel, UNet4to3)):
        kw = dict(
            num_channels=int(net_cfg.get("num_channels", 128)),
            num_res_blocks=int(net_cfg.get("num_res_blocks", 2)),
            channel_mult=tuple(net_cfg.get("channel_mult", (1, 2, 2, 4))),
            num_heads=int(net_cfg.get("num_heads", 4)),
            num_head_channels=int(net_cfg.get("num_head_channels", -1)),
        )
        if isinstance(net, UNet4to3):
            net_sd = compat.unet_4to3_state_dict_from_flax(
                params, image_size=int(net_cfg.get("image_size", 256)),
                attention_resolutions=net_cfg.get("attention_resolutions", (16, 8)), **kw)
        else:
            net_sd = compat.unet_state_dict_from_flax(
                params, image_size=int(net.dim[-1]), attention_resolutions=net_cfg.get("attention_resolutions", "16"),
                class_cond=bool(net_cfg.get("class_cond", False)), **kw)
    else:
        raise NotImplementedError(f"no converter for the net {type(net).__name__}")
    heads = {}
    for name in task.heads:
        if name != "frac_head":
            raise NotImplementedError(f"no converter for the head {name}")
        heads[name] = compat.frac_head_state_dict_from_flax(params["frac_head"])
    return net_sd, heads


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> str:
    import jax

    from stain2stain_tpu.training.state import CheckpointIO as JaxCheckpointIO
    from stain2stain_tpu_torch.compat import load_strict
    from stain2stain_tpu_torch.training.state import CheckpointIO, TrainState
    from stain2stain_tpu_torch.utils.utils import instantiate_task

    ckpt_path, out = cfg.get("ckpt_path"), cfg.get("out")
    if not ckpt_path or not out:
        raise ValueError("both ckpt_path=<Orbax checkpoint dir> and +out=<dir> are required")
    state, meta = JaxCheckpointIO().restore(ckpt_path)
    variables = jax.device_get({"params": state.params, **dict(state.extra_vars or {})})
    task = instantiate_task(cfg["model"], device=cfg.get("device") or "cpu")
    net_sd, heads = port_state_dicts(task, cfg["model"], variables)
    load_strict(task.net, net_sd)
    for name, sd in heads.items():
        load_strict(task.heads[name], sd)
    optimizer, _ = task.configure_optimizers()
    step = int(jax.device_get(state.step))
    port_meta = {
        "epoch": int(meta.get("epoch", 0) or 0),
        "global_step": int(meta.get("global_step", step) or 0),
        "converted_from": str(ckpt_path),
        "weights_only_conversion": True,
    }
    CheckpointIO().save(out, TrainState(step=step, net=task.net, optimizer=optimizer, heads=task.heads), port_meta)
    print(f"Converted {ckpt_path} -> {out} (epoch {port_meta['epoch']}, step {port_meta['global_step']})")
    return str(out)


if __name__ == "__main__":
    main()

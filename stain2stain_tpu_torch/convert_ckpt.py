"""Convert a reference (torch Lightning) checkpoint into a port checkpoint
directory (counterpart of ``src/convert_ckpt.py``).

    python -m stain2stain_tpu_torch.convert_ckpt ckpt_path=/path/to/best.ckpt \
        model=conditional_flow_matching +out=converted_ckpt [device=cpu]

Reads the Lightning ``.ckpt`` with ``torch.load(weights_only=True)``, loads
its weights strictly into the task of ``cfg.model`` (built on the CUDA card
unless ``device=cpu``) and writes ``<out>/state.pt`` (``model``, a fresh
optimizer state from the task's ``configure_optimizers``, ``step`` =
``global_step``) and ``<out>/meta.json`` (``epoch``, ``global_step``,
``converted_from``, ``weights_only_conversion: true``), which
``ckpt_path=<out>`` of the eval, inference, serving and export CLIs loads and
``train`` resumes from. Conversion is weights-only: the Adam moments are not
carried.

- UNet families: the ``net_prefix`` (``net.``) entries; a missing or
  unexpected key raises ``ConversionError`` naming it.
- Multitask families: the ``encoder`` / ``flow_decoder`` / ``seg_decoder``
  entries as they are, only under ``+model.{encoder,flow_decoder,seg_decoder}.norm=batch``
  (the checkpoints carry BatchNorm running statistics).
- The aux-fraction task: the reference file holds no ``frac_head``; the
  head is written as the task's own initialization draws it, and
  ``meta.json`` lists it under ``initialized_heads``. (The JAX converter
  writes no head, and the JAX task then fails on the missing key.)

Flags (composable overrides):
  ckpt_path=...          the torch .ckpt file (required)
  +out=DIR               output checkpoint directory (required)
  model=...              model config matching the checkpoint architecture
  +attention_order=new   for nets trained with use_new_attention_order=True
  +net_prefix=...        the velocity net's attribute prefix (default net.)
  +unsafe_load=true      allow full unpickling for ckpts whose metadata defeats
                         torch.load(weights_only=True) (trusted files only)
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from .compat import convert_lightning_state_dict, convert_multitask_state_dict, load_strict
from .config import Config, config_main
from .training.state import CheckpointIO, TrainState
from .utils.pylogger import RankedLogger
from .utils.utils import instantiate_task

log = RankedLogger(__name__, rank_zero_only=True)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _load_torch_ckpt(path: str, unsafe: bool) -> dict:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:
        if not unsafe:
            raise RuntimeError(
                f"torch.load(weights_only=True) failed ({str(exc)[:200]}). "
                "Lightning checkpoints whose hyper_parameters embed custom "
                "objects need full unpickling — re-run with +unsafe_load=true "
                "if you trust the file."
            ) from exc
        return torch.load(path, map_location="cpu", weights_only=False)


def convert(cfg: Config) -> str:
    """Write the port checkpoint directory of ``cfg.ckpt_path`` to ``cfg.out``."""
    ckpt_path, out = cfg.get("ckpt_path"), cfg.get("out")
    if not ckpt_path or not out:
        raise ValueError("both ckpt_path=<torch .ckpt> and +out=<dir> are required")
    ckpt = _load_torch_ckpt(str(ckpt_path), bool(cfg.get("unsafe_load", False)))
    state_dict = ckpt.get("state_dict", ckpt)  # plain state dicts work too

    model_cfg = cfg["model"]
    if "encoder" in model_cfg:  # the multitask shared-encoder family
        if model_cfg["encoder"].get("norm", "group") != "batch":
            raise ValueError(
                "reference multitask checkpoints carry BatchNorm running stats "
                "— convert AND evaluate with +model.encoder.norm=batch "
                "+model.flow_decoder.norm=batch +model.seg_decoder.norm=batch"
            )
        net_sd = convert_multitask_state_dict(state_dict)
    else:
        net_cfg = model_cfg["net"]
        net_sd = convert_lightning_state_dict(
            state_dict,
            net_prefix=str(cfg.get("net_prefix", "net.")),
            num_heads=int(net_cfg.get("num_heads", 4)),
            num_head_channels=int(net_cfg.get("num_head_channels", -1)),
            attention_order=str(cfg.get("attention_order", "legacy")),
        )
    task = instantiate_task(model_cfg, device=cfg.get("device"))
    load_strict(task.net, net_sd)
    optimizer, _ = task.configure_optimizers()
    step = int(ckpt.get("global_step", 0) or 0)
    meta = {
        "epoch": int(ckpt.get("epoch", 0) or 0),
        "global_step": step,
        "converted_from": str(ckpt_path),
        "weights_only_conversion": True,
    }
    if task.heads:  # trained beside the net by this port's task; a reference file holds none
        meta["initialized_heads"] = sorted(task.heads)
        log.warning(f"{ckpt_path} holds no {sorted(task.heads)}: written as the task's initialization draws them")
    CheckpointIO().save(out, TrainState(step=step, net=task.net, optimizer=optimizer, heads=task.heads), meta)
    log.info(f"Converted {ckpt_path} -> {out} (epoch {meta['epoch']}, step {meta['global_step']})")
    return str(out)


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> str:
    return convert(cfg)


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

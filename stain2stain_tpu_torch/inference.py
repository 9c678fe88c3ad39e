"""Shared machinery of the config-driven inference CLIs (counterpart of
``stain2stain_tpu/inference.py``): load a checkpoint, iterate the test
loader, generate batch by batch, write side-by-side panels.

A panel row is written with PIL: the named images side by side, with no
titles (the JAX package draws titled matplotlib figures; the card's machine
has no matplotlib).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .compat import load_reference_checkpoint
from .config import Config, instantiate
from .ops.image import denormalize
from .training.state import load_heads
from .utils.pylogger import RankedLogger
from .utils.utils import instantiate_task

log = RankedLogger(__name__, rank_zero_only=True)


def _read_checkpoint(ckpt_path: str) -> tuple[dict, dict, dict]:
    """(net state dict, head state dicts, meta) of a checkpoint: a directory
    of the port's trainer (``state.pt`` + ``meta.json``), or a ``.pt`` state
    dict or a reference Lightning ``.ckpt`` file (no heads, meta ``{}``)."""
    path = Path(ckpt_path)
    if not path.is_dir():
        return load_reference_checkpoint(path), {}, {}
    if not (path / "state.pt").is_file():
        raise FileNotFoundError(f"No checkpoint at {path}")
    saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    meta_file = path / "meta.json"
    meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    if meta:
        log.info(f"Restored checkpoint (epoch {meta.get('epoch')}, step {meta.get('global_step')})")
    return saved["model"], saved.get("heads", {}), meta


def load_state(ckpt_path: str) -> tuple[dict, dict]:
    """(net state dict, meta) of a checkpoint directory, ``.pt`` or ``.ckpt`` file."""
    model, _, meta = _read_checkpoint(ckpt_path)
    return model, meta


def load_task(cfg: Config):
    """The task of ``cfg.model`` with its nets on ``cfg.device`` (the CUDA card
    unless ``device=cpu``) and the weights of ``cfg.ckpt_path``, its heads'
    too (the aux-fraction head)."""
    model, heads, _ = _read_checkpoint(cfg["ckpt_path"])
    task = instantiate_task(cfg["model"], device=cfg.get("device"))
    task.net.load_state_dict(model, strict=True)
    load_heads(task.heads, {"heads": heads}, cfg["ckpt_path"])
    return task


def save_panel(path: Path, panels: dict[str, np.ndarray], index: int) -> None:
    """One row of the named panels' ``index``-th images, side by side, as a PNG
    (one-channel panels in gray)."""
    from PIL import Image

    row = []
    for img in panels.values():
        img = np.clip(np.asarray(img[index], np.float32), 0.0, 1.0)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        row.append((img * 255).astype(np.uint8))
    Image.fromarray(np.concatenate(row, axis=1)).save(path)


def run_inference(cfg: Config, generate_fn: Callable) -> Path:
    """Data and task from ``cfg``, weights from ``cfg.ckpt_path``, then
    ``generate_fn(task, prepared_batch) -> {name: [0, 1] images}`` per test
    batch; one PNG per example under ``<output_dir>/panels`` (at most
    ``cfg.n_images``). Returns that directory."""
    log.info(f"Instantiating datamodule <{cfg['data']['_target_']}>")
    datamodule = instantiate(cfg["data"])
    log.info(f"Instantiating model <{cfg['model']['_target_']}>")
    task = load_task(cfg)

    datamodule.prepare_data()
    datamodule.setup("test")
    loader = datamodule.test_dataloader() or datamodule.val_dataloader()
    if loader is None:
        raise RuntimeError("Datamodule provides no test/val loader for inference")

    out_dir = Path(cfg.get("paths", {}).get("output_dir", ".")) / "panels"
    out_dir.mkdir(parents=True, exist_ok=True)
    n_images: Optional[int] = cfg.get("n_images")
    written = 0
    for batch in loader:
        prepared = task.prepare_batch(task.device_fields(batch), train=False)
        panels = {k: v.cpu().numpy() for k, v in generate_fn(task, prepared).items()}
        for i in range(next(iter(panels.values())).shape[0]):
            save_panel(out_dir / f"sample_{written:05d}.png", panels, i)
            written += 1
            if n_images is not None and written >= n_images:
                log.info(f"Wrote {written} panels to {out_dir}")
                return out_dir
    log.info(f"Wrote {written} panels to {out_dir}")
    return out_dir


def basic_panels(task, prepared: tuple, num_steps: int) -> dict:
    """source / generated / target panels."""
    src, tgt = prepared[0], prepared[1]
    gen = task.generate(src, num_steps=num_steps)
    return {"source": denormalize(src), "generated": denormalize(gen), "target": denormalize(tgt)}


__all__ = ["load_state", "load_task", "save_panel", "run_inference", "basic_panels"]

"""Experiment loggers (counterpart of ``stain2stain_tpu/training/loggers.py:21-90, 120-160``).

:class:`CSVLogger` writes ``metrics.csv`` and ``hparams.json`` under
``save_dir/name/version_N``; :class:`FileLogger` is the JAX package's local
JSONL sink (its fallback for absent tracking services). The TensorBoard and
service loggers (wandb, mlflow, neptune, comet, aim) are not ported yet.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Optional

import numpy as np


class Logger:
    """Logger interface: hyperparams, scalar metrics, image panels."""

    name: str = "logger"

    def log_hyperparams(self, params: dict) -> None:
        pass

    def log_metrics(self, metrics: dict, step: int) -> None:
        pass

    def log_images(self, tag: str, images: dict, step: int) -> None:
        """images: mapping name → (N, H, W, C) float array in [0, 1]."""

    def log_model(self, ckpt_path: str, metadata: Optional[dict] = None) -> None:
        """Register a checkpoint as a model artifact."""

    def finalize(self, status: str = "success") -> None:
        pass


class CSVLogger(Logger):
    """metrics.csv + hparams.json under save_dir/name/version_N (``configs/logger/csv.yaml``)."""

    name = "csv"
    # the file is rewritten every N rows (its columns grow as train/val/test
    # keys appear), so a run cut short keeps its metrics history
    flush_every = 50

    def __init__(self, save_dir: str = "logs", name: str = "csv", prefix: str = "", version: Optional[int] = None):
        base = Path(save_dir) / name
        if version is None:
            existing = [int(p.name.split("_")[1]) for p in base.glob("version_*") if p.name.split("_")[-1].isdigit()]
            version = max(existing, default=-1) + 1
        self.log_dir = base / f"version_{version}"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self._rows: list[dict] = []
        self._fields: set[str] = {"step"}

    def log_hyperparams(self, params: dict) -> None:
        (self.log_dir / "hparams.json").write_text(json.dumps(params, indent=2, default=str))

    def log_metrics(self, metrics: dict, step: int) -> None:
        row = {"step": step}
        for k, v in metrics.items():
            key = f"{self.prefix}{k}" if self.prefix else k
            row[key] = float(v)
            self._fields.add(key)
        self._rows.append(row)
        if len(self._rows) % self.flush_every == 0:
            self._write()

    def _write(self) -> None:
        with open(self.log_dir / "metrics.csv", "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=sorted(self._fields))
            writer.writeheader()
            writer.writerows(self._rows)

    def finalize(self, status: str = "success") -> None:
        if self._rows:
            self._write()


class FileLogger(Logger):
    """Local JSONL sink: metrics, hyperparameters, model paths and PNG panels."""

    def __init__(self, save_dir: str = "logs", name: str = "file"):
        self.log_dir = Path(save_dir) / name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")
        self.name = name

    def log_hyperparams(self, params: dict) -> None:
        self._file.write(json.dumps({"hparams": params}, default=str) + "\n")

    def log_metrics(self, metrics: dict, step: int) -> None:
        self._file.write(json.dumps({"step": step, **{k: float(v) for k, v in metrics.items()}}) + "\n")

    def log_model(self, ckpt_path: str, metadata: Optional[dict] = None) -> None:
        self._file.write(json.dumps({"model_artifact": str(ckpt_path), **(metadata or {})}, default=str) + "\n")
        self._file.flush()

    def log_images(self, tag: str, images: dict, step: int) -> None:
        from PIL import Image

        out = self.log_dir / "images" / f"step_{step}"
        out.mkdir(parents=True, exist_ok=True)
        for name, imgs in images.items():
            for i, img in enumerate(np.asarray(imgs)[:8]):
                pixels = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
                if pixels.ndim == 3 and pixels.shape[-1] == 1:
                    pixels = pixels[..., 0]  # a mask panel: PIL takes (H, W) gray, not (H, W, 1)
                Image.fromarray(pixels).save(out / f"{tag}_{name}_{i}.png")

    def finalize(self, status: str = "success") -> None:
        self._file.close()


__all__ = ["Logger", "CSVLogger", "FileLogger"]

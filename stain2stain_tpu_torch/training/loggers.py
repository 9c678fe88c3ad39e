"""Experiment loggers (counterpart of ``stain2stain_tpu/training/loggers.py``).

- :class:`CSVLogger` writes ``metrics.csv`` and ``hparams.json`` under
  ``save_dir/name/version_N``;
- :class:`TensorBoardLogger` writes event files through tensorboardX (an
  ``ImportError`` where it is not installed, as in JAX);
- :class:`FileLogger` is the local JSONL sink;
- the service loggers (:class:`WandbLogger`, :class:`MLFlowLogger`,
  :class:`NeptuneLogger`, :class:`CometLogger`, :class:`AimLogger`) write
  the same JSONL under ``save_dir/<service>`` and warn when their client
  library is absent. ``WandbLogger.log_model`` mirrors a checkpoint into the
  ``$WANDB_CACHE_DIR`` layout that ``train._resolve_ckpt_path`` reads for a
  ``wandb-artifact://`` reference; with the wandb client installed it runs
  ``wandb.init`` and logs the checkpoint as an artifact instead.
"""

from __future__ import annotations

import csv
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, Optional

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
    """Local JSONL sink: metrics, hyperparameters, model paths and PNG panels.

    Each record is appended and the file closed again, so records written
    after :meth:`finalize` land too: the entry point logs the test metrics
    after ``fit`` has finalized its loggers (the JAX package's sink closes
    its file there and fails on them, ``training/loggers.py:157-158``).
    """

    def __init__(self, save_dir: str = "logs", name: str = "file"):
        self.log_dir = Path(save_dir) / name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.jsonl"
        self.path.touch()
        self.name = name

    def _append(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def log_hyperparams(self, params: dict) -> None:
        self._append({"hparams": params})

    def log_metrics(self, metrics: dict, step: int) -> None:
        self._append({"step": step, **{k: float(v) for k, v in metrics.items()}})

    def log_model(self, ckpt_path: str, metadata: Optional[dict] = None) -> None:
        self._append({"model_artifact": str(ckpt_path), **(metadata or {})})

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


class TensorBoardLogger(Logger):
    """Scalars, hyperparameters (as text) and image panels through tensorboardX."""

    name = "tensorboard"

    def __init__(self, save_dir: str = "logs", name: str = "tensorboard", default_hp_metric: bool = True,
                 prefix: str = ""):
        from tensorboardX import SummaryWriter

        self.log_dir = Path(save_dir) / name
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.writer = SummaryWriter(str(self.log_dir))
        self.prefix = prefix

    def log_hyperparams(self, params: dict) -> None:
        self.writer.add_text("hparams", json.dumps(params, indent=2, default=str))

    def log_metrics(self, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            self.writer.add_scalar(f"{self.prefix}{k}", float(v), step)

    def log_images(self, tag: str, images: dict, step: int) -> None:
        for name, imgs in images.items():
            for i, img in enumerate(np.asarray(imgs)[:8]):
                self.writer.add_image(f"{tag}/{name}_{i}", img, step, dataformats="HWC")

    def finalize(self, status: str = "success") -> None:
        self.writer.close()


def artifact_cache_dir(ref: str) -> Path:
    """Where a ``wandb-artifact://<ref>`` checkpoint is mirrored without the
    wandb client: ``$WANDB_CACHE_DIR`` (default ``wandb_artifacts``) /
    ``<ref with / and : as _>``."""
    return Path(os.environ.get("WANDB_CACHE_DIR", "wandb_artifacts")) / ref.replace("/", "_").replace(":", "_")


def _service_logger(service: str):
    """A logger class for a tracking service (its client's import name): the
    :class:`FileLogger` JSONL under ``save_dir/<service>``, and a warning when
    the client is not installed."""

    class ServiceLogger(FileLogger):
        def __init__(self, save_dir: str = "logs", project: str = "stain2stain", offline: bool = False,
                     **kwargs: Any):
            self.project = project
            self.kwargs = kwargs
            self._client = None
            try:
                __import__(service)
                available = True
            except ImportError:
                available = False
                warnings.warn(f"{service} is not installed; {service} logging degrades to a local JSONL file.",
                              stacklevel=2)
            super().__init__(save_dir=str(save_dir), name=service)
            if available and service == "wandb":
                import wandb

                self._client = wandb.init(
                    project=project,
                    dir=str(save_dir),
                    mode="offline" if offline else None,
                    config=None,
                    **{k: v for k, v in kwargs.items() if k in ("name", "group", "tags", "id", "job_type", "entity")},
                )

        def log_metrics(self, metrics: dict, step: int) -> None:
            super().log_metrics(metrics, step)
            if self._client is not None:
                self._client.log({k: float(v) for k, v in metrics.items()}, step=step)

        def artifact_ref(self, alias: str = "latest") -> str:
            """The ``wandb-artifact://`` reference of this run's model:
            ``<project>/model-<run name>:<alias>`` (``log_model: all``
            registers ``model-<run>`` with a ``latest`` alias,
            ``configs/logger/wandb.yaml``)."""
            run_name = self.kwargs.get("name") or getattr(self._client, "id", None) or "run"
            return f"{self.project}/model-{run_name}:{alias}"

        def log_model(self, ckpt_path: str, metadata: Optional[dict] = None) -> None:
            """Record the checkpoint with its ``artifact_ref``; upload it as a
            model artifact with the wandb client, else mirror it (a directory
            or a file) into :func:`artifact_cache_dir`, replacing the copy a
            previous call left there."""
            super().log_model(ckpt_path, {**(metadata or {}), "artifact_ref": self.artifact_ref()})
            p = Path(ckpt_path)
            if self._client is not None and service == "wandb":
                import wandb

                name = self.artifact_ref().split("/")[-1].split(":")[0]
                artifact = wandb.Artifact(name, type="model", metadata=metadata or {})
                if p.is_dir():
                    artifact.add_dir(str(p))
                else:
                    artifact.add_file(str(p))
                self._client.log_artifact(artifact, aliases=["latest"])
                return
            cache = artifact_cache_dir(self.artifact_ref())
            if cache.exists():
                shutil.rmtree(cache)
            if p.is_dir():
                shutil.copytree(p, cache)
            else:
                cache.mkdir(parents=True, exist_ok=True)
                shutil.copy2(p, cache / p.name)

        def finalize(self, status: str = "success") -> None:
            super().finalize(status)
            if self._client is not None:
                self._client.finish()

    ServiceLogger.__name__ = ServiceLogger.__qualname__ = f"{service.capitalize()}Logger"
    return ServiceLogger


WandbLogger = _service_logger("wandb")
MLFlowLogger = _service_logger("mlflow")
NeptuneLogger = _service_logger("neptune")
CometLogger = _service_logger("comet_ml")
AimLogger = _service_logger("aim")


__all__ = [
    "Logger",
    "CSVLogger",
    "TensorBoardLogger",
    "FileLogger",
    "WandbLogger",
    "MLFlowLogger",
    "NeptuneLogger",
    "CometLogger",
    "AimLogger",
    "artifact_cache_dir",
]

"""Trainer callbacks (counterpart of ``stain2stain_tpu/training/callbacks.py``).

ModelCheckpoint (monitor / top-k / last / every_n_epochs / filename
patterns), EarlyStopping (patience / min_delta / check_finite / thresholds),
ModelSummary, ProgressBar, LearningRateMonitor and the epoch-end ImageLogger,
with the JAX package's config surface and semantics.

With several processes the hooks run on every rank: their decisions read
``callback_metrics``, which are means over the ranks and so the same
everywhere, and the checkpoint save is collective. Files, deletions and
logger calls are rank 0's (JAX ``callbacks.py:114-118``).
"""

from __future__ import annotations

import math
import re
import shutil
import time
from pathlib import Path
from typing import Any, Optional


class Callback:
    def on_fit_start(self, trainer, task) -> None: ...

    def on_train_epoch_start(self, trainer, task) -> None: ...

    def on_train_batch_end(self, trainer, task, metrics: dict) -> None: ...

    def on_train_epoch_end(self, trainer, task) -> None: ...

    def on_validation_epoch_end(self, trainer, task) -> None: ...

    def on_fit_end(self, trainer, task) -> None: ...

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


def _format_filename(pattern: str, metrics: dict, epoch: int) -> str:
    """Expand 'best-{epoch:03d}-{val/loss:.4f}' style patterns (``callbacks.py:45-58``)."""

    def repl(m: re.Match) -> str:
        key, fmt = m.group(1), m.group(2) or ""
        value: Any = epoch if key == "epoch" else metrics.get(key, float("nan"))
        return format(value, fmt) if fmt else str(value)

    out = re.sub(r"\{([^{}:]+)(?::([^{}]+))?\}", repl, pattern)
    return out.replace("/", "_")


class ModelCheckpoint(Callback):
    """Top-k + last checkpointing on a monitored metric
    (config: ``configs/callbacks/model_checkpoint.yaml``)."""

    def __init__(
        self,
        dirpath: Optional[str] = None,
        filename: str = "epoch_{epoch:03d}",
        monitor: Optional[str] = "val/loss",
        mode: str = "min",
        save_last: bool = True,
        save_top_k: int = 1,
        every_n_epochs: int = 1,
        auto_insert_metric_name: bool = False,
        verbose: bool = False,
        save_weights_only: bool = False,
        save_on_train_epoch_end: Optional[bool] = None,
        log_model: bool = True,
    ):
        self.log_model = log_model
        # None → True (Lightning's default for the 'last' write): save_last
        # runs at every train epoch end; False defers it to validation end.
        self.save_on_train_epoch_end = save_on_train_epoch_end is not False
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.mode = mode
        self.save_last = save_last
        self.save_top_k = save_top_k
        self.every_n_epochs = max(1, every_n_epochs or 1)
        self.verbose = verbose
        self.kept: list[tuple[float, str]] = []  # (score, path), best first
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""

    def _dir(self, trainer) -> Path:
        return Path(self.dirpath) if self.dirpath else Path(trainer.default_root_dir) / "checkpoints"

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def _save_last(self, trainer) -> None:
        if self.save_last:
            self.last_model_path = str(self._dir(trainer) / "last")
            trainer.save_checkpoint(self.last_model_path)

    def on_train_epoch_end(self, trainer, task) -> None:
        if not trainer.sanity_checking and self.save_on_train_epoch_end:
            self._save_last(trainer)

    def on_validation_epoch_end(self, trainer, task) -> None:
        if trainer.sanity_checking:
            return
        epoch = trainer.current_epoch
        metrics = trainer.callback_metrics
        # refresh 'last' after a real validation, so a resume from it carries
        # this validation's scheduler and top-k state (``callbacks.py:133-142``)
        if getattr(trainer, "_val_ran", True) or not self.save_on_train_epoch_end:
            self._save_last(trainer)
        if self.monitor is None or self.monitor not in metrics:
            return
        if (epoch + 1) % self.every_n_epochs != 0 or self.save_top_k == 0:
            return
        score = float(metrics[self.monitor])
        if math.isnan(score):
            return
        path = str(self._dir(trainer) / _format_filename(self.filename, metrics, epoch))
        if self.save_top_k == -1 or len(self.kept) < self.save_top_k or self._better(score, self.kept[-1][0]):
            trainer.save_checkpoint(path)
            # one entry per path, with its newest score
            self.kept = [(sc, pa) for sc, pa in self.kept if pa != path]
            self.kept.append((score, path))
            self.kept.sort(key=lambda sp: sp[0], reverse=(self.mode == "max"))
            while self.save_top_k != -1 and len(self.kept) > self.save_top_k:
                _, drop = self.kept.pop()
                if (trainer.is_global_zero and drop != path and not any(pa == drop for _, pa in self.kept)
                        and Path(drop).exists()):
                    shutil.rmtree(drop, ignore_errors=True)
            self.best_model_score, self.best_model_path = self.kept[0]
            if self.log_model and trainer.is_global_zero:
                for logger in trainer.loggers:
                    logger.log_model(path, {"epoch": epoch, self.monitor: score})
            if self.verbose:
                trainer.print(f"Saved checkpoint {path} ({self.monitor}={score:.5f})")

    def state_dict(self) -> dict:
        return {
            "kept": self.kept,
            "best_model_path": self.best_model_path,
            "best_model_score": self.best_model_score,
            "last_model_path": self.last_model_path,
        }

    def load_state_dict(self, state: dict) -> None:
        self.kept = [tuple(x) for x in state.get("kept", [])]
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")
        self.last_model_path = state.get("last_model_path", "")


class EarlyStopping(Callback):
    """Stop when the monitored metric stops improving
    (config: ``configs/callbacks/early_stopping.yaml``)."""

    def __init__(
        self,
        monitor: str = "val/loss",
        min_delta: float = 0.0,
        patience: int = 3,
        mode: str = "min",
        strict: bool = True,
        check_finite: bool = True,
        stopping_threshold: Optional[float] = None,
        divergence_threshold: Optional[float] = None,
        verbose: bool = False,
        check_on_train_epoch_end: Optional[bool] = None,
        log_rank_zero_only: bool = False,
    ):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.mode = mode
        self.strict = strict
        self.check_finite = check_finite
        self.stopping_threshold = stopping_threshold
        self.divergence_threshold = divergence_threshold
        self.verbose = verbose
        self.wait = 0
        self.best = math.inf if mode == "min" else -math.inf

    def _improved(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def _past(self, value: float, threshold: Optional[float], below_stops: bool) -> bool:
        if threshold is None:
            return False
        return value <= threshold if below_stops else value >= threshold

    def on_validation_epoch_end(self, trainer, task) -> None:
        if trainer.sanity_checking:
            return
        metrics = trainer.callback_metrics
        if self.monitor not in metrics:
            if self.strict:
                raise RuntimeError(
                    f"EarlyStopping monitor '{self.monitor}' not found in logged metrics: {sorted(metrics)}"
                )
            return
        value = float(metrics[self.monitor])
        if self.check_finite and not math.isfinite(value):
            trainer.should_stop = True
            trainer.print(f"EarlyStopping: non-finite {self.monitor}={value}, stopping.")
            return
        minimizing = self.mode == "min"
        if self._past(value, self.stopping_threshold, minimizing) or self._past(
            value, self.divergence_threshold, not minimizing
        ):
            trainer.should_stop = True
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True
                if self.verbose:
                    trainer.print(f"EarlyStopping triggered on {self.monitor} (best {self.best:.5f})")

    def state_dict(self) -> dict:
        return {"wait": self.wait, "best": self.best}

    def load_state_dict(self, state: dict) -> None:
        self.wait = state.get("wait", 0)
        self.best = state.get("best", self.best)


class ModelSummary(Callback):
    """Parameter-count summary at fit start (RichModelSummary parity)."""

    def __init__(self, max_depth: int = 1):
        self.max_depth = max_depth

    def on_fit_start(self, trainer, task) -> None:
        net = task.net
        trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
        buffers = sum(b.numel() for b in net.buffers())
        trainer.print(f"Model parameters: {trainable/1e6:.2f}M trainable, {buffers/1e6:.2f}M non-trainable buffers")


RichModelSummary = ModelSummary


class ProgressBar(Callback):
    """Console progress with loss and throughput (RichProgressBar stand-in)."""

    def __init__(self, refresh_rate: int = 1, leave: bool = False):
        self.refresh_rate = refresh_rate
        self._t0 = None
        self._count = 0

    def on_train_epoch_start(self, trainer, task) -> None:
        self._t0 = time.time()
        self._count = 0

    def on_train_batch_end(self, trainer, task, metrics: dict) -> None:
        self._count += 1
        if self._count % max(1, 50 // self.refresh_rate):
            return
        dt = time.time() - self._t0
        loss = metrics.get("loss")
        loss_s = f" loss={float(loss):.4f}" if loss is not None else ""
        trainer.print(
            f"epoch {trainer.current_epoch} step {trainer.global_step}{loss_s} "
            f"({self._count / max(dt, 1e-6):.2f} it/s)"
        )

    def on_train_epoch_end(self, trainer, task) -> None:
        if self._t0 is not None:
            trainer.print(f"epoch {trainer.current_epoch} done in {time.time() - self._t0:.1f}s")


RichProgressBar = ProgressBar


class LearningRateMonitor(Callback):
    def __init__(self, logging_interval: Optional[str] = "epoch"):
        self.logging_interval = logging_interval

    def on_train_epoch_end(self, trainer, task) -> None:
        lr = trainer.current_lr
        if lr is not None:
            trainer.log_metrics({"lr": lr})


class ImageLogger(Callback):
    """Epoch-end source / generated / target panels through a cheap few-step sampler."""

    def __init__(self, num_steps: int = 2, every_n_epochs: int = 1):
        self.num_steps = num_steps
        self.every_n_epochs = max(1, every_n_epochs)

    def on_validation_epoch_end(self, trainer, task) -> None:
        if (
            trainer.sanity_checking
            or not getattr(task, "log_images", False)
            or (trainer.current_epoch + 1) % self.every_n_epochs
        ):
            return
        # every rank draws (the counter stays in step for a resume); rank 0
        # renders, on its own rows: the sampler runs no collective (whole
        # parameters on every rank, BatchNorm in eval mode)
        generator = trainer.next_generator()
        batch = trainer.peek_val_batch() or trainer.peek_train_batch()
        if batch is None or not trainer.is_global_zero:
            return
        panels = task.render_panels(batch, generator, num_steps=self.num_steps)
        for logger in trainer.loggers:
            logger.log_images("val", panels, trainer.global_step)


__all__ = [
    "Callback",
    "ModelCheckpoint",
    "EarlyStopping",
    "ModelSummary",
    "RichModelSummary",
    "ProgressBar",
    "RichProgressBar",
    "LearningRateMonitor",
    "ImageLogger",
]

"""The Trainer: explicit PyTorch train and eval loops on one device
(counterpart of ``stain2stain_tpu/training/trainer.py``).

- one train step: batch prep and shared augmentation on the device, forward
  and backward (gradient accumulation over micro-batches, global-norm
  clipping), optimizer update;
- one eval step under ``torch.no_grad``; val/test means are weighted by each
  batch's example count;
- the host-side epoch loop owns validation cadence (``check_val_every_n_epoch``,
  ``val_check_interval``), callbacks, loggers, ReduceLROnPlateau and early
  stopping;
- checkpoints hold model, optimizer, scheduler and callback state, so resume
  is exact;
- tasks that declare ``track_best`` get running best values of their
  metrics after every validation (``val/acc_best`` for the MNIST sweep);
- ``profiler``: ``"simple"`` prints the mean and median train step;
  ``"jax"`` or ``"advanced"`` runs ``torch.profiler`` over the fit loop
  (after the sanity validation, CUDA activity too on the card) and writes
  a Chrome trace into ``<default_root_dir>/profile/``, the directory the
  JAX trainer's trace goes to.

Randomness: every train step draws from a ``torch.Generator`` seeded from
(seed, step) — crop offsets, flips, the flow-matching ``t`` and the dropout
seeds, in that order — so a resumed run draws what an uninterrupted run
would (the JAX trainer folds the step into its key, ``trainer.py:317``).
Eval batch ``i`` draws from a generator seeded from (seed, i), so val/test
losses reproduce exactly across trainers.

Config knobs: ``accelerator`` is ``auto``/``gpu``/``cuda`` (the CUDA card;
raises without one) or ``cpu``; anything else raises. One device only:
``devices`` > 1, ``num_nodes`` > 1 or ``fsdp`` > 1 raise. ``precision``
bf16 variants mean bf16 compute with f32 parameters (the UNet's ``dtype``,
``trainer.py:255-267``). ``strategy``, ``steps_per_execution`` and
``prng_impl`` are accepted for config parity and have no effect: they select
JAX dispatch and PRNG implementations.
"""

from __future__ import annotations

import math
import os
import time
from pathlib import Path
from typing import Any, Optional, Sequence

import torch

from .._device import resolve_device
from ..utils.pylogger import RankedLogger
from ..utils.seed import current_seed
from .callbacks import Callback, ModelCheckpoint
from .loggers import Logger
from .optim import ReduceLROnPlateau, get_learning_rate, set_learning_rate
from .state import CheckpointIO, TrainState

log = RankedLogger(__name__, rank_zero_only=True)

_ACCELERATORS = {"auto": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}
_FULL_PRECISION = (None, 32, "32", "32-true")
_BF16_PRECISION = ("bf16", "bf16-mixed", "bf16-true", "16-mixed", "16", "16-true")

# streams of the per-(seed, index) generators
_TRAIN_STREAM, _EVAL_STREAM, _AUX_STREAM = 0, 1, 2


def _one_device(devices: Any) -> bool:
    if devices in (None, "auto", -1, "-1"):
        return True
    if isinstance(devices, (list, tuple)):
        return len(devices) == 1
    return int(devices) == 1


def seeded_generator(seed: int, stream: int, index: int) -> torch.Generator:
    """A CPU generator that depends only on (seed, stream, index)."""
    mixed = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + index) % 2**64
    return torch.Generator(device="cpu").manual_seed(mixed)


class Trainer:
    def __init__(
        self,
        default_root_dir: Optional[str] = None,
        min_epochs: int = 0,
        max_epochs: int = 10,
        accelerator: str = "auto",
        devices: Any = "auto",
        num_nodes: int = 1,
        strategy: str = "auto",
        precision: Any = None,
        check_val_every_n_epoch: int = 1,
        limit_train_batches: Any = None,
        limit_val_batches: Any = None,
        limit_test_batches: Any = None,
        fast_dev_run: bool = False,
        log_every_n_steps: int = 50,
        gradient_clip_val: Optional[float] = None,
        accumulate_grad_batches: int = 1,
        deterministic: bool = False,
        detect_anomaly: bool = False,
        num_sanity_val_steps: int = 0,
        callbacks: Optional[Sequence[Callback]] = None,
        logger: Any = None,
        profiler: Optional[str] = None,
        fsdp: int = 1,
        fsdp_min_size: int = 1024,
        sync_batchnorm: bool = False,
        max_steps: int = -1,
        overfit_batches: Any = 0,
        val_check_interval: Any = None,
        enable_progress_bar: bool = True,
        enable_checkpointing: bool = True,
        enable_model_summary: bool = True,
        inference_mode: bool = True,
        prng_impl: Optional[str] = None,
        steps_per_execution: int = 1,
    ):
        accel = str(accelerator).lower()
        if accel not in _ACCELERATORS:
            raise ValueError(
                f"trainer.accelerator={accelerator!r} is not supported by the port: it trains on one "
                "CUDA card (trainer.accelerator=auto, gpu or cuda) or on the CPU (trainer=cpu)"
            )
        if not _one_device(devices) or int(num_nodes or 1) > 1 or int(fsdp or 1) > 1:
            raise ValueError(
                f"the port trains on one device: got trainer.devices={devices!r}, "
                f"num_nodes={num_nodes!r}, fsdp={fsdp!r}"
            )
        if precision not in _FULL_PRECISION and str(precision) not in _BF16_PRECISION:
            raise ValueError(f"trainer.precision={precision!r} is not supported (32 or a bf16 variant)")
        self.device = resolve_device(_ACCELERATORS[accel])
        self.default_root_dir = str(default_root_dir or Path.cwd() / "logs")
        self.min_epochs = min_epochs or 0
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.precision = precision
        self.check_val_every_n_epoch = max(1, check_val_every_n_epoch or 1)
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.log_every_n_steps = log_every_n_steps
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = max(1, accumulate_grad_batches)
        self.detect_anomaly = detect_anomaly
        self.val_check_interval = val_check_interval
        self.num_sanity_val_steps = num_sanity_val_steps
        self.profiler = profiler

        self.callbacks: list[Callback] = list(callbacks or [])
        if logger is None or logger is False:
            self.loggers: list[Logger] = []
        elif isinstance(logger, Logger):
            self.loggers = [logger]
        else:
            self.loggers = [lg for lg in logger if isinstance(lg, Logger)]

        self.state: Optional[TrainState] = None
        self.task = None
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.sanity_checking = False
        self.callback_metrics: dict[str, float] = {}
        self._aux_draws = 0
        self._scheduler: Optional[ReduceLROnPlateau] = None
        self._base_lr: Optional[float] = None
        self._ckpt_io = CheckpointIO()
        self._peek_train = None
        self._peek_val = None

        if fast_dev_run:
            self.max_epochs = 1
            self.limit_train_batches = 1
            self.limit_val_batches = 1
            self.limit_test_batches = 1
            self.check_val_every_n_epoch = 1
        self._overfit = bool(overfit_batches)
        if overfit_batches:
            # the epoch permutation is pinned to epoch 0, so the same batches repeat
            self.limit_train_batches = overfit_batches
            self.limit_val_batches = overfit_batches

    # ------------------------------------------------------------------ utils
    @property
    def current_lr(self) -> Optional[float]:
        return None if self.state is None else get_learning_rate(self.state.optimizer)

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        return next((cb for cb in self.callbacks if isinstance(cb, ModelCheckpoint)), None)

    def print(self, *args: Any) -> None:
        print(*args, flush=True)

    def next_generator(self) -> torch.Generator:
        """A fresh generator for draws outside the step counter (image panels)."""
        self._aux_draws += 1
        return seeded_generator(current_seed(), _AUX_STREAM, self._aux_draws)

    def log_metrics(self, metrics: dict) -> None:
        self.callback_metrics.update({k: float(v) for k, v in metrics.items()})
        for logger in self.loggers:
            logger.log_metrics(metrics, self.global_step)

    def peek_train_batch(self):
        return self._peek_train

    def peek_val_batch(self):
        return self._peek_val

    def _limit(self, limit: Any, total: int) -> int:
        if limit is None or limit is False:
            return total
        if isinstance(limit, float) and 0 < limit <= 1:
            return max(1, int(total * limit))
        return min(int(limit), total)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ setup
    def _prepare_task(self, task) -> None:
        self.task = task
        task.to(self.device)
        if str(self.precision) in _BF16_PRECISION:
            task.net.dtype = torch.bfloat16  # bf16 compute, f32 parameters

    def _init_state(self, task) -> None:
        optimizer, self._scheduler = task.configure_optimizers()
        self.state = TrainState(step=0, net=task.net, optimizer=optimizer, heads=dict(task.heads))
        if self._base_lr is None:
            self._base_lr = get_learning_rate(optimizer)

    def _train_step(self, task, batch: tuple, augment: Optional[dict]) -> dict:
        state = self.state
        generator = seeded_generator(current_seed(), _TRAIN_STREAM, state.step)
        prepared = task.prepare_batch(task.device_fields(batch), generator, train=True, augment=augment)
        accum = self.accumulate_grad_batches
        if accum == 1:
            loss, metrics = task.loss_and_metrics(prepared, generator, train=True)
            loss.backward()
        else:
            if prepared[0].shape[0] % accum:
                raise ValueError(
                    f"batch of {prepared[0].shape[0]} does not split into accumulate_grad_batches={accum}"
                )
            metrics = {}
            for micro in zip(*(x.chunk(accum) for x in prepared)):
                loss, m = task.loss_and_metrics(micro, generator, train=True)
                (loss / accum).backward()  # the mean of the micro-batch gradients
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v / accum
        if self.gradient_clip_val:
            grads = [p.grad for p in task.trainable_parameters() if p.grad is not None]
            gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32).square()) for g in grads))
            scale = torch.clamp(self.gradient_clip_val / (gnorm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return metrics

    # ------------------------------------------------------------------- fit
    def fit(self, model, datamodule, ckpt_path: Optional[str] = None) -> None:
        task = model
        self._prepare_task(task)
        datamodule.prepare_data()
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        if train_loader is None:
            raise RuntimeError("DataModule returned no train dataloader")
        val_loader = datamodule.val_dataloader()
        augment = getattr(datamodule, "train_augment", None)
        self._peek_train = next(iter(train_loader))
        self._init_state(task)

        start_epoch = self._restore(ckpt_path) if ckpt_path else 0
        for cb in self.callbacks:
            cb.on_fit_start(self, task)
        if self.num_sanity_val_steps and val_loader is not None:
            self.sanity_checking = True
            self._run_eval(val_loader, prefix="val", max_batches=self.num_sanity_val_steps)
            self.sanity_checking = False

        profiler = self._start_profiler()
        try:
            for epoch in range(start_epoch, self.max_epochs):
                self.current_epoch = epoch
                if self.should_stop and epoch >= self.min_epochs:
                    break
                for cb in self.callbacks:
                    cb.on_train_epoch_start(self, task)
                self._run_train_epoch(task, train_loader, augment, val_loader=val_loader)
                for cb in self.callbacks:
                    cb.on_train_epoch_end(self, task)
                self.log_metrics({"epoch": float(epoch)})
                ran_val = val_loader is not None and (epoch + 1) % self.check_val_every_n_epoch == 0
                if ran_val:
                    self._run_eval(val_loader, prefix="val")
                    self._track_best(task)
                # validation-driven control flow fires only on epochs that
                # validated (or every epoch without a val loader)
                if ran_val or val_loader is None:
                    self._epoch_end_control_flow(task)
                    self._val_ran = ran_val
                    for cb in self.callbacks:
                        cb.on_validation_epoch_end(self, task)
                if self.max_steps > 0 and self.global_step >= self.max_steps:
                    break
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            for cb in self.callbacks:
                cb.on_fit_end(self, task)
            for logger in self.loggers:
                logger.finalize()

    def _start_profiler(self):
        """A started ``torch.profiler`` for ``profiler="jax"|"advanced"``, else None."""
        if self.profiler not in ("jax", "advanced"):
            return None
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> Path:
        """Stop ``profiler`` and write its Chrome trace under ``<default_root_dir>/profile``."""
        self._sync()
        profiler.stop()
        profile_dir = Path(self.default_root_dir) / "profile"
        profile_dir.mkdir(parents=True, exist_ok=True)
        trace = profile_dir / f"fit-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json"
        profiler.export_chrome_trace(str(trace))
        log.info(f"Profiler trace written to {profile_dir}")
        return trace

    def _run_train_epoch(self, task, loader, augment, val_loader=None) -> None:
        loader.set_epoch(0 if self._overfit else self.current_epoch)
        n_batches = self._limit(self.limit_train_batches, len(loader))
        val_every: Optional[int] = None
        if val_loader is not None and self.val_check_interval:
            if isinstance(self.val_check_interval, float) and 0 < self.val_check_interval <= 1:
                val_every = max(1, int(n_batches * self.val_check_interval))
            else:
                val_every = max(1, int(self.val_check_interval))
        epoch_metrics: dict[str, list] = {}
        step_times: list[float] = []

        for i, batch in enumerate(loader):
            if i >= n_batches:
                break
            self._peek_train = batch
            t0 = time.perf_counter()
            metrics = self._train_step(task, batch, augment)
            if self.profiler == "simple":
                self._sync()
                step_times.append(time.perf_counter() - t0)
            if self.detect_anomaly:
                loss_val = float(metrics["loss"])
                if not math.isfinite(loss_val):
                    raise FloatingPointError(f"Non-finite loss at step {self.global_step}: {loss_val}")
            self.global_step += 1
            for k, v in metrics.items():
                epoch_metrics.setdefault(k, []).append(v)
            if self.global_step % self.log_every_n_steps == 0:
                self.log_metrics({f"train/{k}": float(v) for k, v in metrics.items()})
            for cb in self.callbacks:
                cb.on_train_batch_end(self, task, metrics)
            done = i + 1
            if val_every and done % val_every == 0 and done < n_batches:
                self._run_eval(val_loader, prefix="val")
                self._track_best(task)
                self._val_ran = True
                for cb in self.callbacks:
                    cb.on_validation_epoch_end(self, task)
            if self.should_stop or (self.max_steps > 0 and self.global_step >= self.max_steps):
                break
        means = {
            f"train/{k}": float(torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in vs]).mean())
            for k, vs in epoch_metrics.items()
        }
        self.log_metrics(means)
        if step_times:
            ordered = sorted(step_times)
            self.print(
                f"[profiler] train_step mean {sum(step_times) / len(step_times) * 1e3:.1f}ms "
                f"p50 {ordered[len(ordered) // 2] * 1e3:.1f}ms over {len(step_times)} steps"
            )

    def _run_eval(self, loader, prefix: str, max_batches: Optional[int] = None) -> dict:
        task = self.task
        limit = self.limit_val_batches if prefix == "val" else self.limit_test_batches
        n_batches = self._limit(limit, len(loader))
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)
        agg: dict[str, list] = {}
        weights: list[int] = []
        with torch.no_grad():
            for i, batch in enumerate(loader):
                if i >= n_batches:
                    break
                if prefix == "val":
                    self._peek_val = batch
                generator = seeded_generator(current_seed(), _EVAL_STREAM, i)
                prepared = task.prepare_batch(task.device_fields(batch), generator, train=False)
                _, metrics = task.loss_and_metrics(prepared, generator, train=False)
                weights.append(prepared[0].shape[0])
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(v)
        # example-weighted means: a short final batch counts by its size
        w = torch.tensor(weights, dtype=torch.float64)
        means = {
            f"{prefix}/{k}": float((torch.stack([torch.as_tensor(v) for v in vs]).double().cpu() * w).sum() / w.sum())
            for k, vs in agg.items()
        }
        if not self.sanity_checking:
            self.log_metrics(means)
        return means

    def _track_best(self, task) -> None:
        """Running best values (JAX ``trainer.py:770-780``): a task declares
        ``track_best = {"val/acc": ("max", "val/acc_best")}``, and each
        validation logs the best ``val/acc`` so far as ``val/acc_best``."""
        for metric, (mode, name) in getattr(task, "track_best", {}).items():
            if metric not in self.callback_metrics:
                continue
            value = self.callback_metrics[metric]
            prev = self.callback_metrics.get(name)
            best = value if prev is None else (max(prev, value) if mode == "max" else min(prev, value))
            self.log_metrics({name: best})

    def _epoch_end_control_flow(self, task) -> None:
        """ReduceLROnPlateau on the monitored metric."""
        if self._scheduler is None or self._base_lr is None:
            return
        monitor = getattr(task, "monitor", "val/loss")
        if monitor not in self.callback_metrics:
            return
        new_lr = self._scheduler.step(self.callback_metrics[monitor], self._base_lr)
        if new_lr is not None:
            set_learning_rate(self.state.optimizer, new_lr)
            log.info(f"ReduceLROnPlateau: lr → {new_lr:.3e}")

    # ------------------------------------------------------------- validation
    def validate(self, model, datamodule, ckpt_path: Optional[str] = None) -> dict:
        return self._standalone_eval(model, datamodule, ckpt_path, split="val")

    def test(self, model, datamodule, ckpt_path: Optional[str] = None) -> dict:
        return self._standalone_eval(model, datamodule, ckpt_path, split="test")

    def _standalone_eval(self, model, datamodule, ckpt_path: Optional[str], split: str) -> dict:
        task = model
        self._prepare_task(task)
        datamodule.setup(split)
        loader = datamodule.test_dataloader() if split == "test" else datamodule.val_dataloader()
        if loader is None:
            log.warning(f"No {split} dataloader; skipping.")
            return {}
        if self.state is None:
            self._init_state(task)
        if ckpt_path in ("last", "best"):
            cb = self.checkpoint_callback
            resolved = ""
            if cb is not None:
                resolved = cb.last_model_path if ckpt_path == "last" else cb.best_model_path
            if not resolved:
                raise ValueError(
                    f'ckpt_path="{ckpt_path}" but no ModelCheckpoint callback has a '
                    f"recorded {ckpt_path} checkpoint path; pass an explicit path"
                )
            ckpt_path = resolved
        if ckpt_path:
            self._restore(ckpt_path, weights_only=True)
        return self._run_eval(loader, prefix=split)

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, path: str) -> None:
        meta = {
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "callback_metrics": self.callback_metrics,
            "scheduler": self._scheduler.state_dict() if self._scheduler else {},
            "base_lr": self._base_lr,
            "callbacks": {type(cb).__name__: cb.state_dict() for cb in self.callbacks},
            # generators are rebuilt from (seed, step); draws outside the step
            # counter (image panels) are counted
            "rng": {"impl": "torch.Generator", "seed": current_seed(), "aux_draws": self._aux_draws},
        }
        self._ckpt_io.save(path, self.state, meta)

    def _restore(self, path: str, weights_only: bool = False) -> int:
        meta = self._ckpt_io.restore(path, self.state, weights_only=weights_only)
        if weights_only:
            return 0
        self.current_epoch = int(meta.get("epoch", 0))
        self.global_step = int(meta.get("global_step", 0))
        self.callback_metrics.update(meta.get("callback_metrics", {}))
        self._base_lr = meta.get("base_lr", self._base_lr)
        if self._scheduler is not None and meta.get("scheduler"):
            self._scheduler.load_state_dict(meta["scheduler"])
        self._aux_draws = int(meta.get("rng", {}).get("aux_draws", 0))
        for cb in self.callbacks:
            cb.load_state_dict(meta.get("callbacks", {}).get(type(cb).__name__, {}))
        log.info(f"Restored checkpoint from {path} (epoch {self.current_epoch})")
        return self.current_epoch + 1


__all__ = ["Trainer", "seeded_generator"]

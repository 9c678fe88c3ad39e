"""The Trainer: explicit PyTorch train and eval loops, in one process or one
process a device (counterpart of ``stain2stain_tpu/training/trainer.py``).

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
  JAX trainer's trace goes to;
- spans (:mod:`..utils.tracing`): any ``torch.profiler`` session, such as
  ``trainer.profiler=advanced``'s, records the roots that begin while it
  runs: ``train.step`` (attribute ``step``; it ends before the step's
  callbacks) over ``train.data_wait`` (the loader's ``next``),
  ``train.prepare`` (``device_fields`` and ``prepare_batch``),
  ``train.forward_backward``, ``train.optimizer`` (clipping, ``step``,
  ``zero_grad``) and, on steps that log, ``train.log``; and the roots
  ``train.epoch_end`` and ``train.validate`` (``train.test`` for test
  runs). They appear in the Chrome trace as CPU events and in
  ``tracing.spans()`` after the session.

Randomness: every train step draws from a ``torch.Generator`` seeded from
(seed, step) — crop offsets, flips, the flow-matching ``t`` and the dropout
seeds, in that order — so a resumed run draws what an uninterrupted run
would (the JAX trainer folds the step into its key, ``trainer.py:317``).
Eval batch ``i`` draws from a generator seeded from (seed, i), so val/test
losses reproduce exactly across trainers.

Data parallelism (a process group is up, :mod:`..parallel`): each rank holds
rows ``rank::W`` of every global batch and the trainer keeps the JAX
package's global-batch semantics by hand, where JAX's global arrays give them:

- the generators know the rank's rows: per-example draws are made for the
  global batch and sliced, so a W-rank step equals the one-process step on
  the same global batch (dropout masks excepted: ``ops/dropout.draw_seed``);
- the task's loss runs through ``DistributedDataParallel`` (one module over
  the net and the task's heads), which averages the gradients over the
  ranks; accumulation micro-batches but the last run under ``no_sync``; the
  clipping norm is then the global one on every rank;
- inside the train and eval steps (:func:`~..parallel.mesh.sharded_batch`)
  the sums a loss, a metric or a BatchNorm normalizes by span every rank's
  rows (Dice, the ROI means, the BatchNorm statistics);
- ``fsdp`` > 1 shards the optimizer's moments over the mesh's fsdp dim
  (:class:`~..parallel.zero.ShardedOptimizer`, ZeRO stage 1);
- logged train metrics and every eval batch's metrics are means over the
  ranks, eval batches weighted by their real example count
  (``loader.real_batch_size``), so ``val/loss`` is one number on every rank
  and the checkpoint, early-stopping and plateau decisions agree;
- rank 0 alone runs ``prepare_data`` (the others wait at a host barrier),
  prints, logs and writes files; every rank calls the checkpoint save (the
  gather is collective) and restores.

Config knobs: ``accelerator`` is ``auto``/``gpu``/``cuda`` (the card
``LOCAL_RANK``; raises without one) or ``cpu``; anything else raises.
``devices`` and ``num_nodes`` ask for processes, which the entry point starts
(``train.py``); a Trainer without a process group that is asked for more than
one device warns and trains on one, as JAX uses the devices present
(``trainer.py:242-253``). ``fsdp`` that does not divide the world size falls
back to 1 (JAX ``trainer.py:251``). ``precision`` bf16 variants mean bf16
compute with f32 parameters (the UNet's ``dtype``, ``trainer.py:255-267``).
``strategy``, ``sync_batchnorm``, ``steps_per_execution`` and ``prng_impl``
are accepted for config parity and have no effect: the BatchNorms are synced
whenever there are several ranks, and the others select JAX dispatch and
PRNG implementations.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import time
import warnings
from pathlib import Path
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .._device import resolve_device
from ..parallel.distributed import host_barrier, is_initialized, local_rank, process_count, process_index
from ..parallel.launch import requested_devices
from ..parallel.mesh import create_mesh, sharded_batch, sharded_generator
from ..parallel.zero import ShardedOptimizer
from ..utils import tracing
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
_END = object()  # what the train loader's iterator gives when it is spent


def seeded_generator(seed: int, stream: int, index: int, rows: tuple = (0, 1)) -> torch.Generator:
    """A CPU generator that depends only on (seed, stream, index); ``rows``
    (this rank, the world size) makes its per-example draws global-batch ones."""
    mixed = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + index) % 2**64
    return sharded_generator(mixed, rows)


class _TaskLoss(nn.Module):
    """The task's training loss as one module over the net and the task's
    heads: what ``DistributedDataParallel`` wraps, so every trained parameter
    is averaged over the ranks."""

    def __init__(self, task):
        super().__init__()
        self.net = task.net
        self.heads = nn.ModuleDict(task.heads)
        self.task = task  # not a module: its net and heads are the submodules above

    def forward(self, batch: tuple, generator: torch.Generator):
        return self.task.loss_and_metrics(batch, generator, train=True)


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
        if precision not in _FULL_PRECISION and str(precision) not in _BF16_PRECISION:
            raise ValueError(f"trainer.precision={precision!r} is not supported (32 or a bf16 variant)")
        self.distributed = is_initialized()  # a process group is up (a world of 1 too: torchrun -n 1)
        self.rank, self.world = process_index(), process_count()
        asked = requested_devices(devices) * max(1, int(num_nodes or 1))
        if not self.distributed and asked > 1:
            log.warning(
                f"Requested {asked} devices (trainer.devices={devices!r}, num_nodes={num_nodes!r}) but no process "
                "group is up; training on one device (the entry point or torchrun starts one process a device)"
            )
        elif self.distributed and asked != self.world:
            log.info(f"trainer.devices={devices!r}: the process group's {self.world} ranks train")
        self.fsdp = max(1, int(fsdp or 1))
        if self.world % self.fsdp:
            log.warning(f"fsdp={self.fsdp} does not divide the world size {self.world}; using fsdp=1")
            self.fsdp = 1
        self.fsdp_min_size = fsdp_min_size
        device = _ACCELERATORS[accel]
        if device == "cuda" and self.distributed:
            device = f"cuda:{local_rank()}"
        self.device = resolve_device(device)
        if self.device.index is not None:
            torch.cuda.set_device(self.device)
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
        self._ddp: Optional[nn.Module] = None
        self._mesh = None

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
    def is_global_zero(self) -> bool:
        return self.rank == 0

    @property
    def world_size(self) -> int:
        return self.world

    @property
    def current_lr(self) -> Optional[float]:
        return None if self.state is None else get_learning_rate(self.state.optimizer)

    @property
    def checkpoint_callback(self) -> Optional[ModelCheckpoint]:
        return next((cb for cb in self.callbacks if isinstance(cb, ModelCheckpoint)), None)

    def print(self, *args: Any) -> None:
        if self.is_global_zero:
            print(*args, flush=True)

    def next_generator(self) -> torch.Generator:
        """A fresh generator for draws outside the step counter (image panels)."""
        self._aux_draws += 1
        return seeded_generator(current_seed(), _AUX_STREAM, self._aux_draws)

    def log_metrics(self, metrics: dict) -> None:
        """Record ``metrics`` (already means over the ranks) on every rank;
        the loggers write on rank 0 (JAX ``trainer.py:217-225``)."""
        self.callback_metrics.update({k: float(v) for k, v in metrics.items()})
        if not self.is_global_zero:
            return
        for logger in self.loggers:
            logger.log_metrics(metrics, self.global_step)

    def _rows(self) -> tuple:
        return (self.rank, self.world)

    def _sharded(self):
        """The train or eval step's batch spans the ranks (a no-op in one process)."""
        return sharded_batch(dist.group.WORLD if self.world > 1 else None)

    def _mean_over_ranks(self, values: list) -> list[float]:
        """Per-position means over the ranks of equal-length lists of scalars."""
        if self.world == 1 or not values:
            return [float(v) for v in values]
        t = torch.tensor([float(v) for v in values], dtype=torch.float64)
        dist.all_reduce(t)
        return (t / self.world).tolist()

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
        if self.fsdp > 1:
            if self._mesh is None:
                self._mesh = create_mesh(self.world, self.fsdp, device_type=self.device.type)
            optimizer = ShardedOptimizer(optimizer, self._mesh, min_size=self.fsdp_min_size)
        self.state = TrainState(step=0, net=task.net, optimizer=optimizer, heads=dict(task.heads))
        if self._base_lr is None:
            self._base_lr = get_learning_rate(optimizer)

    def _wrap_ddp(self, task) -> None:
        """``DistributedDataParallel`` over the task's loss whenever a process
        group is up; it broadcasts rank 0's parameters and buffers once. The
        BatchNorms keep their buffers equal by their synced statistics, so
        they are not broadcast every step."""
        if not self.distributed:
            return
        from torch.nn.parallel import DistributedDataParallel

        device_ids = [self.device.index] if self.device.type == "cuda" else None
        with warnings.catch_warnings():  # newer torch renames broadcast_buffers; older lacks the new name
            warnings.simplefilter("ignore", FutureWarning)
            self._ddp = DistributedDataParallel(_TaskLoss(task), device_ids=device_ids, broadcast_buffers=False)

    def _train_step(self, task, batch: tuple, augment: Optional[dict]) -> dict:
        state = self.state
        generator = seeded_generator(current_seed(), _TRAIN_STREAM, state.step, self._rows())
        with tracing.span("train.prepare"):
            prepared = task.prepare_batch(task.device_fields(batch), generator, train=True, augment=augment)
        with tracing.span("train.forward_backward"), self._sharded():
            metrics = self._forward_backward(task, prepared, generator)
        with tracing.span("train.optimizer"):
            # DDP has averaged the gradients over the ranks by now: the norm is the global one
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

    def _forward_backward(self, task, prepared: tuple, generator: torch.Generator) -> dict:
        """Loss and gradients of one prepared batch, over ``accumulate_grad_batches`` micro-batches."""
        accum = self.accumulate_grad_batches
        if self._ddp is not None:
            loss_fn = self._ddp
        else:
            def loss_fn(b, g):
                return task.loss_and_metrics(b, g, train=True)
        if accum == 1:
            loss, metrics = loss_fn(prepared, generator)
            loss.backward()
        else:
            if prepared[0].shape[0] % accum:
                raise ValueError(
                    f"batch of {prepared[0].shape[0]} does not split into accumulate_grad_batches={accum}"
                )
            metrics = {}
            for k, micro in enumerate(zip(*(x.chunk(accum) for x in prepared))):
                # the gradient all-reduce runs once, in the last micro-batch's backward
                last = k == accum - 1
                with contextlib.nullcontext() if last or self._ddp is None else self._ddp.no_sync():
                    loss, m = loss_fn(micro, generator)
                    (loss / accum).backward()  # the mean of the micro-batch gradients
                for name, v in m.items():
                    metrics[name] = metrics.get(name, 0.0) + v / accum
        return metrics

    # ------------------------------------------------------------------- fit
    def fit(self, model, datamodule, ckpt_path: Optional[str] = None) -> None:
        task = model
        self._prepare_task(task)
        if self.is_global_zero:  # side effects (downloads, split files) once, read by every rank after
            datamodule.prepare_data()
        host_barrier("prepare_data")
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        if train_loader is None:
            raise RuntimeError("DataModule returned no train dataloader")
        val_loader = datamodule.val_dataloader()
        augment = getattr(datamodule, "train_augment", None)
        self._peek_train = next(iter(train_loader))
        self._init_state(task)
        self._wrap_ddp(task)

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

    def _stop_profiler(self, profiler) -> Optional[Path]:
        """Stop ``profiler`` and write its Chrome trace under ``<default_root_dir>/profile`` (rank 0)."""
        self._sync()
        profiler.stop()
        if not self.is_global_zero:
            return None
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
        batches = iter(loader)

        for i in itertools.count():
            # the root ends before the callbacks: they are the caller's code
            with tracing.root("train.step", step=self.global_step) as step:
                with tracing.span("train.data_wait"):
                    batch = next(batches, _END)
                if batch is _END or i >= n_batches:
                    step.drop()
                    break
                self._peek_train = batch
                if self.profiler == "simple":
                    t0 = time.perf_counter()
                metrics = self._train_step(task, batch, augment)
                if self.profiler == "simple":
                    self._sync()
                    step_times.append(time.perf_counter() - t0)
                if self.detect_anomaly:
                    loss_val = self._mean_over_ranks([metrics["loss"]])[0]
                    if not math.isfinite(loss_val):
                        raise FloatingPointError(f"Non-finite loss at step {self.global_step}: {loss_val}")
                self.global_step += 1
                for k, v in metrics.items():
                    epoch_metrics.setdefault(k, []).append(v)
                if self.global_step % self.log_every_n_steps == 0:
                    with tracing.span("train.log"):
                        keys = sorted(metrics)
                        self.log_metrics(dict(zip((f"train/{k}" for k in keys),
                                                  self._mean_over_ranks([metrics[k] for k in keys]))))
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
        with tracing.root("train.epoch_end", step=self.global_step):
            keys = sorted(epoch_metrics)
            local = [torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in epoch_metrics[k]]).mean()
                     for k in keys]
            self.log_metrics(dict(zip((f"train/{k}" for k in keys), self._mean_over_ranks(local))))
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
        real_of = getattr(loader, "real_batch_size", None)
        with tracing.root("train.validate" if prefix == "val" else f"train.{prefix}"), torch.no_grad():
            for i, batch in enumerate(loader):
                if i >= n_batches:
                    break
                if prefix == "val":
                    self._peek_val = batch
                generator = seeded_generator(current_seed(), _EVAL_STREAM, i, self._rows())
                prepared = task.prepare_batch(task.device_fields(batch), generator, train=False)
                with self._sharded():
                    _, metrics = task.loss_and_metrics(prepared, generator, train=False)
                weights.append(real_of(i) if callable(real_of) else prepared[0].shape[0] * self.world)
                for k, v in metrics.items():
                    agg.setdefault(k, []).append(v)
        # each batch's metrics: the mean over the ranks' equal slices (the
        # padded global batch's mean); then example-weighted means over the
        # batches, a short final batch counting by its real size
        keys = sorted(agg)
        per_batch = self._mean_over_ranks([v for k in keys for v in agg[k]])
        w = torch.tensor(weights, dtype=torch.float64)
        means = {
            f"{prefix}/{k}": float((torch.tensor(per_batch[j * len(w):(j + 1) * len(w)], dtype=torch.float64) * w).sum()
                                   / w.sum())
            for j, k in enumerate(keys)
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

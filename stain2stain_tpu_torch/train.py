"""Training CLI of the port (counterpart of ``src/train.py``).

    python -m stain2stain_tpu_torch.train experiment=smoke_synthetic trainer=cpu
    python -m stain2stain_tpu_torch.train experiment=quality_synthetic_256 trainer.accelerator=gpu
    python -m stain2stain_tpu_torch.train -m hparams_search=mnist_optuna experiment=example trainer=cpu

Composes ``configs/train.yaml`` with the port's config code (the YAMLs'
``stain2stain_tpu.`` targets map onto this package), instantiates the
datamodule, callbacks, loggers and Trainer, then the task with its net on the
trainer's device, runs fit and, with ``test=true``, test on the best
checkpoint. ``ckpt_path=wandb-artifact://<ref>`` resumes from a logged model
(:func:`_resolve_ckpt_path`). Trains on the CUDA card unless ``trainer=cpu``
(``trainer.accelerator=cpu``); an accelerator other than auto / gpu / cuda /
cpu raises. With ``hparams_search=…`` attached, :func:`sweep.run_study` runs
the study, one training run a trial.

Data parallel, one process a device (the JAX package's launch variables work too):

    python -m stain2stain_tpu_torch.train experiment=smoke_synthetic trainer=ddp_sim   # 2 gloo ranks on the CPU
    torchrun --nproc_per_node=N -m stain2stain_tpu_torch.train trainer=ddp trainer.devices=N ...

:func:`main` first joins the process group the launch variables describe;
without one, ``trainer.devices`` N > 1 starts ranks 1…N−1 from this command
line (:mod:`.parallel.launch`). ``data.batch_size`` is the global batch.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from .config import Config, config_main, instantiate
from .parallel.distributed import maybe_initialize_distributed
from .parallel.launch import launch_processes, stop_processes
from .sweep import run_study
from .training.loggers import artifact_cache_dir
from .utils.pylogger import RankedLogger
from .utils.seed import seed_everything
from .utils.utils import (
    extras,
    get_metric_value,
    instantiate_callbacks,
    instantiate_loggers,
    instantiate_task,
    log_hyperparameters,
    share_output_dir,
    task_wrapper,
)

log = RankedLogger(__name__, rank_zero_only=True)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _resolve_ckpt_path(ckpt_path: Optional[str]) -> Optional[str]:
    """A ``wandb-artifact://<ref>`` checkpoint as a local directory (JAX
    ``src/train.py:37-62``): with the wandb client installed the artifact is
    downloaded; without it, the copy ``WandbLogger.log_model`` left under
    ``$WANDB_CACHE_DIR`` is used, and a missing one raises
    ``FileNotFoundError``. Plain paths pass through."""
    if not ckpt_path or not str(ckpt_path).startswith("wandb-artifact://"):
        return ckpt_path
    ref = str(ckpt_path)[len("wandb-artifact://"):]
    try:
        import wandb
    except ImportError:
        cache = artifact_cache_dir(ref)
        if cache.exists():
            log.info(f"Resolved wandb artifact from local cache: {cache}")
            return str(cache)
        raise FileNotFoundError(
            f"ckpt_path '{ckpt_path}' is a wandb artifact but the wandb client is not "
            f"installed and no local cache was found at {cache}."
        ) from None
    return str(Path(wandb.Api().artifact(ref).download()))


@task_wrapper
def train(cfg: Config) -> tuple[dict, dict]:
    """Train (and optionally test on the best checkpoint).

    Returns (metric_dict, object_dict).
    """
    if cfg.get("seed") is not None:
        seed_everything(cfg["seed"], workers=True)

    log.info(f"Instantiating datamodule <{cfg['data']['_target_']}>")
    datamodule = instantiate(cfg["data"])

    log.info("Instantiating callbacks...")
    callbacks = instantiate_callbacks(cfg.get("callbacks"))

    log.info("Instantiating loggers...")
    logger = instantiate_loggers(cfg.get("logger"))

    log.info(f"Instantiating trainer <{cfg['trainer']['_target_']}>")
    trainer = instantiate(cfg["trainer"], callbacks=callbacks, logger=logger)

    # the nets are built on the trainer's device (the CUDA card unless trainer=cpu)
    log.info(f"Instantiating model <{cfg['model']['_target_']}> on {trainer.device}")
    model = instantiate_task(cfg["model"], device=trainer.device)

    object_dict = {
        "cfg": cfg,
        "datamodule": datamodule,
        "model": model,
        "callbacks": callbacks,
        "logger": logger,
        "trainer": trainer,
    }
    if logger:
        log.info("Logging hyperparameters!")
        log_hyperparameters(object_dict)

    ckpt_path = _resolve_ckpt_path(cfg.get("ckpt_path"))
    if cfg.get("train", True):
        log.info("Starting training!")
        trainer.fit(model, datamodule, ckpt_path=ckpt_path)
    train_metrics = dict(trainer.callback_metrics)

    test_metrics: dict = {}
    if cfg.get("test"):
        log.info("Starting testing!")
        ckpt_cb = trainer.checkpoint_callback
        best = ckpt_cb.best_model_path if ckpt_cb else ""
        if not best:
            log.warning("Best ckpt not found! Using current weights for testing...")
            best = None
        test_metrics = trainer.test(model, datamodule, ckpt_path=best)
        log.info(f"Best ckpt path: {best}")

    return {**train_metrics, **test_metrics}, object_dict


@config_main(config_path="../configs", config_name="train.yaml")
def main(cfg: Config) -> Optional[float]:
    maybe_initialize_distributed()
    if cfg.get("sweeper"):
        extras(cfg)
        return run_study(cfg, lambda c: train(c)[0])
    children = launch_processes(cfg["trainer"], bool(cfg.get("runtime", {}).get("command_line")))
    try:
        share_output_dir(cfg)
        extras(cfg)
        metric_dict, _ = train(cfg)
        value = get_metric_value(metric_dict, cfg.get("optimized_metric"))
    except BaseException:
        stop_processes(children, failed=True)
        raise
    stop_processes(children)
    return value


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

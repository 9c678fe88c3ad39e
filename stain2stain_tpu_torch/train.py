"""Training CLI of the port (counterpart of ``src/train.py``).

    python -m stain2stain_tpu_torch.train experiment=smoke_synthetic trainer=cpu
    python -m stain2stain_tpu_torch.train experiment=quality_synthetic_256 trainer.accelerator=gpu

Composes ``configs/train.yaml`` with the port's config code (the YAMLs'
``stain2stain_tpu.`` targets map onto this package), instantiates the
datamodule, callbacks, loggers and Trainer, then the task with its net on the
trainer's device, runs fit and, with ``test=true``, test on the best
checkpoint. Trains on the CUDA card unless ``trainer=cpu``
(``trainer.accelerator=cpu``); an accelerator other than auto / gpu / cuda /
cpu raises. Sweeps (``hparams_search``) are not ported yet.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from .config import Config, config_main, instantiate
from .utils.pylogger import RankedLogger
from .utils.seed import seed_everything
from .utils.utils import (
    extras,
    get_metric_value,
    instantiate_callbacks,
    instantiate_loggers,
    instantiate_task,
    log_hyperparameters,
    task_wrapper,
)

log = RankedLogger(__name__, rank_zero_only=True)

REPO_ROOT = Path(__file__).resolve().parent.parent


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

    ckpt_path = cfg.get("ckpt_path")
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
    if cfg.get("sweeper"):
        raise NotImplementedError("hyperparameter sweeps (hparams_search) are not ported yet")
    extras(cfg)
    metric_dict, _ = train(cfg)
    return get_metric_value(metric_dict, cfg.get("optimized_metric"))


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

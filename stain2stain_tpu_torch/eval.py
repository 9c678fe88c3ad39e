"""Evaluation CLI of the port (counterpart of ``src/eval.py``): the test loop
on a checkpoint.

    python -m stain2stain_tpu_torch.eval ckpt_path=<checkpoint dir> [trainer=cpu] [data=... model=...]

Composes ``configs/eval.yaml``, instantiates the datamodule, loggers,
Trainer and the task with its net on the trainer's device (the CUDA card
unless ``trainer=cpu``), and runs ``Trainer.test`` on ``ckpt_path``. Like
``train``, it joins the process group of the launch variables first, or
starts one process a device for ``trainer.devices`` N > 1; the test means are
then global.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from .config import Config, config_main, instantiate
from .parallel.distributed import host_barrier, process_index
from .parallel.launch import launch_processes, stop_processes
from .utils.pylogger import RankedLogger
from .utils.utils import (
    extras,
    instantiate_loggers,
    instantiate_task,
    log_hyperparameters,
    share_output_dir,
    task_wrapper,
)

log = RankedLogger(__name__, rank_zero_only=True)

REPO_ROOT = Path(__file__).resolve().parent.parent


@task_wrapper
def evaluate(cfg: Config) -> tuple[dict, dict]:
    """Test metrics of ``cfg.ckpt_path``; returns (metric_dict, object_dict)."""
    if not cfg.get("ckpt_path"):
        raise ValueError("ckpt_path is required for evaluation (eval.yaml sets it to ???)")

    log.info(f"Instantiating datamodule <{cfg['data']['_target_']}>")
    datamodule = instantiate(cfg["data"])

    log.info("Instantiating loggers...")
    logger = instantiate_loggers(cfg.get("logger"))

    log.info(f"Instantiating trainer <{cfg['trainer']['_target_']}>")
    trainer = instantiate(cfg["trainer"], logger=logger)

    log.info(f"Instantiating model <{cfg['model']['_target_']}> on {trainer.device}")
    model = instantiate_task(cfg["model"], device=trainer.device)

    object_dict = {"cfg": cfg, "datamodule": datamodule, "model": model, "logger": logger, "trainer": trainer}
    if logger:
        log.info("Logging hyperparameters!")
        log_hyperparameters(object_dict)

    log.info("Starting testing!")
    if process_index() == 0:
        datamodule.prepare_data()
    host_barrier("prepare_data")
    metrics = trainer.test(model, datamodule, ckpt_path=cfg["ckpt_path"])
    return metrics, object_dict


@config_main(config_path="../configs", config_name="eval.yaml")
def main(cfg: Config) -> Optional[dict]:
    children = launch_processes(cfg["trainer"], bool(cfg.get("runtime", {}).get("command_line")))
    try:
        share_output_dir(cfg)
        extras(cfg)
        metric_dict, _ = evaluate(cfg)
    except BaseException:
        stop_processes(children, failed=True)
        raise
    stop_processes(children)
    return metric_dict


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

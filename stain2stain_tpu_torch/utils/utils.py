"""Run orchestration helpers (the port's copy of ``stain2stain_tpu/utils``'s
``instantiators``, ``utils``, ``rich_utils`` and ``logging_utils``).

- :func:`instantiate_callbacks` / :func:`instantiate_loggers` build every
  child with a ``_target_`` of a config group;
- :func:`instantiate_task` builds a task with its networks on a device;
- :func:`extras` applies ``cfg.extras`` (warnings filter, tag enforcement,
  config print);
- :func:`task_wrapper` logs a task's exception and its output dir;
- :func:`get_metric_value` reads the optimized metric;
- :func:`log_hyperparameters` sends the config sections and parameter counts
  to every logger;
- :func:`share_output_dir` gives every rank rank 0's run directory.

Under data parallelism files (tags, the config tree) are written by rank 0.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Callable, Optional

from ..config import Config, instantiate, select
from ..parallel.distributed import broadcast_object, launch_rank
from .pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)


# the nodes of a model config that are networks: ``net`` (the UNet tasks) or
# the three networks of the shared-encoder multitask tasks
_NET_NODES = ("net", "encoder", "flow_decoder", "seg_decoder")


def instantiate_task(model_cfg: Config, device: Any = None):
    """The task of ``model_cfg`` with each of its networks built on ``device``
    (``None``: the CUDA card); the config's own network nodes are not built."""
    nets = {key: instantiate(model_cfg[key], device=device) for key in _NET_NODES if model_cfg.get(key) is not None}
    return instantiate(model_cfg, device=device, **nets)


def _instantiate_group(group_cfg, what: str) -> list:
    objects: list = []
    if not group_cfg:
        log.warning(f"No {what} configs found! Skipping...")
        return objects
    if not isinstance(group_cfg, Config):
        raise TypeError(f"{what.capitalize()} config must be a Config (mapping)!")
    for key in group_cfg:
        conf = group_cfg.get(key)
        if isinstance(conf, Config) and "_target_" in conf:
            log.info(f"Instantiating {what} <{conf['_target_']}>")
            objects.append(instantiate(conf))
    return objects


def instantiate_callbacks(callbacks_cfg) -> list:
    return _instantiate_group(callbacks_cfg, "callback")


def instantiate_loggers(logger_cfg) -> list:
    return _instantiate_group(logger_cfg, "logger")


def _output_dir(cfg: Config) -> Optional[str]:
    return select(cfg, "paths.output_dir", default=None) or select(cfg, "runtime.output_dir", default=None)


def enforce_tags(cfg: Config, save_to_file: bool = False) -> None:
    """Ask for tags when none are set (an error under multirun)."""
    if not cfg.get("tags"):
        if cfg.get("runtime", {}) and select(cfg, "runtime.multirun", default=False):
            raise ValueError("Specify tags before launching a multirun!")
        log.warning("No tags provided in config. Prompting user to input tags...")
        try:
            tags = input("Enter a list of comma separated tags (dev): ") or "dev"
        except EOFError:
            tags = "dev"
        cfg["tags"] = [t.strip() for t in tags.split(",") if t.strip()]
        log.info(f"Tags: {cfg['tags']}")
    out_dir = _output_dir(cfg)
    if save_to_file and out_dir and launch_rank() == 0:
        (Path(out_dir) / "tags.log").write_text(str(list(cfg["tags"])))


def print_config_tree(cfg: Config, resolve: bool = False, save_to_file: bool = False) -> None:
    """Print the composed config as YAML (and save it as ``config_tree.log``)."""
    if launch_rank() != 0:
        return
    text = cfg.to_yaml(resolve=resolve)
    print(text, flush=True)
    out_dir = _output_dir(cfg)
    if save_to_file and out_dir:
        (Path(out_dir) / "config_tree.log").write_text(text)


def extras(cfg: Config) -> None:
    """Apply optional pre-task utilities controlled by ``cfg.extras``."""
    extras_cfg = cfg.get("extras")
    if not extras_cfg:
        log.warning("Extras config not found! <cfg.extras=null>")
        return
    if extras_cfg.get("ignore_warnings"):
        log.info("Disabling python warnings! <extras.ignore_warnings=True>")
        warnings.filterwarnings("ignore")
    if extras_cfg.get("enforce_tags"):
        enforce_tags(cfg, save_to_file=True)
    if extras_cfg.get("print_config"):
        print_config_tree(cfg, resolve=False, save_to_file=True)


def share_output_dir(cfg: Config) -> None:
    """Rank 0's ``runtime.output_dir`` on every rank: each process composed
    its own timestamped directory, and checkpoint paths must agree."""
    out_dir = select(cfg, "runtime.output_dir", default=None)
    shared = broadcast_object(out_dir)
    if shared != out_dir:
        cfg["runtime.output_dir"] = shared


def task_wrapper(task_func: Callable) -> Callable:
    """Wrap a task: log its exception, always log the output dir."""

    def wrap(cfg: Config):
        try:
            return task_func(cfg=cfg)
        except Exception:
            log.exception("")
            raise
        finally:
            out_dir = select(cfg, "paths.output_dir", default=None)
            if out_dir:
                log.info(f"Output dir: {out_dir}")

    return wrap


def get_metric_value(metric_dict: dict, metric_name: Optional[str]) -> Optional[float]:
    """The optimized metric for sweepers."""
    if not metric_name:
        log.info("Metric name is None! Skipping metric value retrieval...")
        return None
    if metric_name not in metric_dict:
        raise ValueError(
            f"Metric value not found! <metric_name={metric_name}>\n"
            "Make sure metric name logged by the task module is correct!\n"
            "Make sure `optimized_metric` name in `hparams_search` config is correct!"
        )
    value = float(metric_dict[metric_name])
    log.info(f"Retrieved metric value! <{metric_name}={value}>")
    return value


def log_hyperparameters(object_dict: dict) -> None:
    cfg, trainer = object_dict["cfg"], object_dict["trainer"]
    if not trainer.loggers:
        log.warning("Logger not found! Skipping hyperparameter logging...")
        return
    hparams: dict[str, Any] = {}
    for key in ("model", "data", "trainer"):
        hparams[key] = cfg.get(key).to_container() if cfg.get(key) else {}
    net = object_dict["model"].net
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    buffers = sum(b.numel() for b in net.buffers())
    hparams["model/params/total"] = trainable + buffers
    hparams["model/params/trainable"] = trainable
    hparams["model/params/non_trainable"] = buffers
    for key in ("extras", "task_name", "tags", "ckpt_path", "seed"):
        if key in cfg:
            hparams[key] = cfg.get(key)
    for logger in trainer.loggers:
        logger.log_hyperparams(hparams)


__all__ = [
    "instantiate_task",
    "instantiate_callbacks",
    "instantiate_loggers",
    "enforce_tags",
    "print_config_tree",
    "extras",
    "task_wrapper",
    "get_metric_value",
    "log_hyperparameters",
    "share_output_dir",
]

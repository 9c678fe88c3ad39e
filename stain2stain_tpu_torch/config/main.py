"""``@config_main`` — hydra.main-equivalent entrypoint decorator.

The port's own copy of ``stain2stain_tpu/config/main.py``. Provides what the
entry points rely on from ``@hydra.main``:

- composes the primary config with ``sys.argv`` overrides
- creates a timestamped output dir (``logs/<task_name>/runs/<ts>``, pattern
  from ``configs/hydra/default.yaml``) and injects it as
  ``runtime.output_dir`` so ``${paths.output_dir}`` resolves
- ``--multirun`` / ``-m``: comma-separated sweeps over override values, each
  job in ``logs/<task_name>/multiruns/<ts>/<job#>``
- saves the composed config to ``<output_dir>/.hydra_equiv/config.yaml``
  (rank 0 of a data-parallel run only)
"""

from __future__ import annotations

import datetime
import functools
import itertools
import sys
from pathlib import Path
from typing import Any, Callable

from ..parallel.distributed import launch_rank
from .compose import compose
from .node import Config, select

_RUNTIME_CFG: Config | None = None


def runtime_config() -> Config | None:
    """The currently executing job's composed config (HydraConfig.get analog)."""
    return _RUNTIME_CFG


def _split_sweeps(overrides: list[str]) -> list[list[str]]:
    """Expand comma-separated override values into a cartesian sweep."""
    axes: list[list[str]] = []
    for ov in overrides:
        if "=" in ov and not ov.startswith("~"):
            key, val = ov.split("=", 1)
            # Don't split bracketed lists: tags=[a,b] is one value.
            if "," in val and not (val.startswith("[") or val.startswith("{") or '"' in val or "'" in val):
                axes.append([f"{key}={v}" for v in val.split(",")])
                continue
        axes.append([ov])
    return [list(combo) for combo in itertools.product(*axes)] if axes else [[]]


def _prepare_run(cfg: Config, output_dir: Path) -> Config:
    cfg["runtime"] = {
        "output_dir": str(output_dir),
        "cwd": str(Path.cwd()),
    }
    cfg._rebind_root(cfg)
    if launch_rank() == 0:  # a process launched for rank 1.. takes rank 0's directory (share_output_dir)
        save_dir = output_dir / ".hydra_equiv"
        save_dir.mkdir(parents=True, exist_ok=True)
        (save_dir / "config.yaml").write_text(cfg.to_yaml(resolve=False))
    return cfg


def config_main(
    config_path: str | Path,
    config_name: str,
    version_base: Any = None,  # accepted for hydra signature parity
) -> Callable:
    """Decorator: compose config from CLI argv and call the task function."""

    def decorator(task_fn: Callable) -> Callable:
        @functools.wraps(task_fn)
        def wrapper(argv: list[str] | None = None) -> Any:
            global _RUNTIME_CFG
            args = list(sys.argv[1:] if argv is None else argv)
            multirun = False
            for flag in ("--multirun", "-m"):
                if flag in args:
                    multirun = True
                    args.remove(flag)
            base = Path(config_path)
            if not base.is_absolute():
                # Resolve relative to the caller's file, like hydra.main does.
                caller_file = Path(sys.modules[task_fn.__module__].__file__).parent
                base = (caller_file / config_path).resolve()

            ts = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            jobs = _split_sweeps(args) if multirun else [args]
            results = []
            for job_num, job_overrides in enumerate(jobs):
                cfg = compose(base, config_name, job_overrides)
                task_name = select(cfg, "task_name", default="run")
                log_dir = Path(select(cfg, "paths.log_dir", default="logs") or "logs")
                if multirun:
                    output_dir = log_dir / task_name / "multiruns" / ts / str(job_num)
                else:
                    output_dir = log_dir / task_name / "runs" / ts
                cfg = _prepare_run(cfg, output_dir)
                cfg["runtime.job_num"] = job_num
                cfg["runtime.multirun"] = multirun
                cfg["runtime.overrides"] = job_overrides
                # the overrides are this process's command line (a launcher may re-run it)
                cfg["runtime.command_line"] = argv is None and not multirun
                _RUNTIME_CFG = cfg
                try:
                    results.append(task_fn(cfg))
                except Exception:
                    if multirun:
                        import traceback

                        traceback.print_exc()
                        results.append(None)
                    else:
                        raise
                finally:
                    _RUNTIME_CFG = None
            return results if multirun else results[0]

        return wrapper

    return decorator


__all__ = ["config_main", "runtime_config"]

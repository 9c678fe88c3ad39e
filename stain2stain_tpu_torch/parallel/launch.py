"""One process a device from the entry points' own command line (the
``ddp`` strategy's launcher in the reference's Lightning runs).

``python -m stain2stain_tpu_torch.train trainer=ddp_sim`` (or any
``trainer.devices`` N > 1) without a process group starts ranks 1…N−1 as
subprocesses of the same command line with the launch variables set
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and a
free ``MASTER_PORT``), and becomes rank 0. On the card N is cut to the cards
visible, with a warning (JAX ``trainer.py:244-249``); on the CPU
(``trainer.accelerator=cpu``) N processes run. Under ``torchrun`` (or the
JAX package's launch variables) nothing is started: the group is joined.

The children re-run this process's command line, so they are started only
when the run's overrides are that command line (an in-process caller, such
as a test calling ``main([...])``, trains on one device instead, with the
Trainer's warning).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Any, Optional

import torch

from ..utils.pylogger import RankedLogger
from .distributed import maybe_initialize_distributed

log = RankedLogger(__name__, rank_zero_only=True)


def requested_devices(devices: Any) -> int:
    """The device count a ``trainer.devices`` value asks for (``auto`` and -1: 1)."""
    if devices in (None, "auto", -1, "-1"):
        return 1
    if isinstance(devices, (list, tuple)):
        return len(devices)
    return int(devices)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _command_line() -> Optional[list[str]]:
    """This process's command line (``python -m <module>`` or ``python <script>``), None
    when it cannot be re-run (``python -c``, an interactive interpreter)."""
    spec = getattr(sys.modules["__main__"], "__spec__", None)
    if spec is not None and spec.name:
        return [sys.executable, "-m", spec.name.removesuffix(".__main__"), *sys.argv[1:]]
    if sys.argv and os.path.isfile(sys.argv[0]):
        return [sys.executable, os.path.abspath(sys.argv[0]), *sys.argv[1:]]
    return None


def launch_processes(trainer_cfg: Any, command_line: bool) -> list[subprocess.Popen]:
    """Join or start the process group for ``trainer_cfg``; returns the
    children this process started (empty when it started none).
    ``command_line``: whether the run's overrides are this process's command
    line, which the children re-run."""
    if maybe_initialize_distributed():
        return []
    asked = requested_devices(trainer_cfg.get("devices"))
    if asked <= 1:
        return []
    cmd = _command_line()
    if not command_line or cmd is None:
        log.warning(f"trainer.devices={asked}: the launcher re-runs the command line, which is not this run's "
                    "overrides or cannot be re-run; not starting processes")
        return []
    on_cpu = str(trainer_cfg.get("accelerator", "auto")).lower() == "cpu"
    visible = asked if on_cpu else torch.cuda.device_count()
    n = min(asked, visible)
    if n < asked:
        log.warning(f"Requested {asked} devices but only {visible} available; using {n}.")
    if n <= 1:
        return []
    common = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": str(n)}
    children = [subprocess.Popen(cmd, env={**os.environ, **common, "RANK": str(r), "LOCAL_RANK": str(r)})
                for r in range(1, n)]
    os.environ.update(common, RANK="0", LOCAL_RANK="0")
    log.info(f"Started ranks 1..{n - 1}: {' '.join(cmd)}")
    try:
        maybe_initialize_distributed()
    except BaseException:
        stop_processes(children, failed=True)
        raise
    return children


def stop_processes(children: list[subprocess.Popen], failed: bool = False) -> None:
    """Wait for the children (kill them when this rank ``failed``); raise if one failed."""
    if failed:
        for child in children:
            child.kill()
    codes = [child.wait() for child in children]
    if not failed and any(codes):
        raise RuntimeError(f"a rank started by the launcher failed: exit codes {codes}")


__all__ = ["launch_processes", "stop_processes", "requested_devices"]

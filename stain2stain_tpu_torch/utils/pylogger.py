"""Rank-aware logging (the port's copy of ``stain2stain_tpu/utils/pylogger.py``).

Messages are prefixed with the process rank and can be restricted to rank 0
or an explicit rank. The rank is read at every message: from
``torch.distributed`` when a process group is up, else from the launch
variables (``RANK``, the JAX package's ``PROCESS_ID``), else 0, so a
process started for rank 1 logs as rank 1 before it joins the group.
"""

from __future__ import annotations

import logging
import os
from typing import Mapping, Optional


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK") or os.environ.get("PROCESS_ID") or 0)


class RankedLogger(logging.LoggerAdapter):
    """Logger adapter prefixing messages with the process rank."""

    def __init__(
        self,
        name: str = __name__,
        rank_zero_only: bool = False,
        extra: Optional[Mapping[str, object]] = None,
    ) -> None:
        logger = logging.getLogger(name)
        if not logging.getLogger().handlers and not logger.handlers:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
            logger.addHandler(handler)
            logger.setLevel(logging.INFO)
        super().__init__(logger=logger, extra=extra)
        self.rank_zero_only = rank_zero_only

    def log(self, level: int, msg: str, *args, rank: Optional[int] = None, **kwargs) -> None:
        if not self.isEnabledFor(level):
            return
        current = _rank()
        msg = f"[rank: {current}] {str(msg)}"
        if self.rank_zero_only or rank == 0:
            if current == 0:
                self.logger.log(level, msg, *args, **kwargs)
        elif rank is None or rank == current:
            self.logger.log(level, msg, *args, **kwargs)


__all__ = ["RankedLogger"]

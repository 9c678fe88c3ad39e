"""Global seeding (the port's copy of ``stain2stain_tpu/utils/seed.py``).

:func:`seed_everything` records the run's seed (the trainer derives every
step's and every eval batch's ``torch.Generator`` from it) and seeds Python,
numpy and torch's default generators, so the nets' random initialization is
reproducible.
"""

from __future__ import annotations

import random

import numpy as np
import torch

_SEED: int = 0


def seed_everything(seed: int | None, workers: bool = True) -> int:
    global _SEED
    _SEED = int(seed or 0)
    random.seed(_SEED)
    np.random.seed(_SEED % (2**32))
    torch.manual_seed(_SEED)
    return _SEED


def current_seed() -> int:
    return _SEED


__all__ = ["seed_everything", "current_seed"]

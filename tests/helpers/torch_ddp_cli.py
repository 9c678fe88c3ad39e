"""The port's training entry point, its metrics printed per rank.

    python tests/helpers/torch_ddp_cli.py experiment=smoke_synthetic trainer=ddp_sim ...

The arguments are the overrides, exactly as ``python -m
stain2stain_tpu_torch.train`` takes them, so with ``trainer.devices`` 2 the
entry point's launcher re-runs this script for rank 1. Each rank prints
``MPFIT rank=… val=… test=… steps=… checksum=…`` (``train`` wrapped to keep
its metrics).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO_ROOT))
os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))

import torch  # noqa: E402

import stain2stain_tpu_torch.train as entry  # noqa: E402


def main() -> None:
    torch.set_num_threads(1)
    seen = {}
    train = entry.train

    def train_and_keep(cfg):
        metrics, objects = train(cfg)
        seen.update(metrics=metrics, trainer=objects["trainer"])
        return metrics, objects

    entry.train = train_and_keep
    entry.main()
    metrics, trainer = seen["metrics"], seen["trainer"]
    checksum = float(sum(p.detach().double().abs().sum() for p in trainer.state.net.parameters()))
    print(f"MPFIT rank={trainer.rank} world={trainer.world_size} steps={trainer.global_step} "
          f"val={metrics['val/loss']!r} test={metrics['test/loss']!r} checksum={checksum!r}", flush=True)


if __name__ == "__main__":
    main()

"""Quality CLI of the port (counterpart of ``src/eval_quality.py``): SSIM,
PSNR and FID of translated tiles against their targets.

    python -m stain2stain_tpu_torch.eval_quality ckpt_path=<checkpoint dir> \
        num_steps=50 [n_batches=8] [device=cpu] [data=... model=...]

Composes ``configs/infer.yaml``, translates the test split (the val split
where there is none) on the CUDA card unless ``device=cpu``, and prints one
JSON line: ``ssim``, ``psnr``, ``fid``, ``fid_extractor``, ``fid_comparable``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

from .config import Config, config_main, instantiate
from .inference import load_task
from .ops.metrics import evaluate_quality

REPO_ROOT = Path(__file__).resolve().parent.parent


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> dict:
    datamodule = instantiate(cfg["data"])
    task = load_task(cfg)
    datamodule.prepare_data()
    datamodule.setup("test")
    loader = datamodule.test_dataloader() or datamodule.val_dataloader()
    if loader is None:
        raise RuntimeError("No test/val loader for quality evaluation")
    metrics = evaluate_quality(task, loader, num_steps=int(cfg.get("num_steps", 50)),
                               max_batches=cfg.get("n_batches"))
    print(json.dumps(metrics), flush=True)
    return metrics


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

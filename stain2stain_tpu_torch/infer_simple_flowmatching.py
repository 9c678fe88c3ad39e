"""Simple flow-matching inference CLI of the port (counterpart of
``src/infer_simple_flowmatching.py``).

    python -m stain2stain_tpu_torch.infer_simple_flowmatching ckpt_path=<checkpoint dir> \
        data.data_dir=<tiles> num_steps=2 [n_images=8] [device=cpu]

Translates the test split on the CUDA card unless ``device=cpu`` and writes
one source / generated / target panel PNG per tile under
``<output_dir>/panels``.
"""

from __future__ import annotations

import os
from pathlib import Path

from .config import Config, config_main
from .inference import basic_panels, run_inference

REPO_ROOT = Path(__file__).resolve().parent.parent


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> Path:
    num_steps = int(cfg.get("num_steps", 2))
    return run_inference(cfg, lambda task, prepared: basic_panels(task, prepared, num_steps))


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

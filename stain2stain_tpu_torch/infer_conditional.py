"""Mask-conditioned inference CLI of the port (counterpart of ``src/infer_conditional.py``).

    python -m stain2stain_tpu_torch.infer_conditional ckpt_path=<checkpoint dir> \
        model=conditional_flow_matching_mask_toggeling data=paired_data_mask_he_amyloid \
        data.data_dir=<tiles> num_steps=50 [+zero_mask=true] [n_images=8] [device=cpu]

For the mask-conditioned and toggled-mask models: each test tile is
integrated with its mask concatenated at every velocity evaluation, or a
zero mask with ``+zero_mask=true``, on the CUDA card unless ``device=cpu``.
One source / generated / target / mask panel PNG a tile (the mask in gray)
under ``<output_dir>/panels``.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from .config import Config, config_main
from .inference import run_inference
from .ops.image import denormalize

REPO_ROOT = Path(__file__).resolve().parent.parent


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> Path:
    num_steps = int(cfg.get("num_steps", 50))
    zero_mask = bool(cfg.get("zero_mask", False))

    def panels(task, prepared):
        src, tgt, mask = prepared[0], prepared[1], prepared[2]
        gen = task.generate(src, num_steps=num_steps, mask=torch.zeros_like(mask) if zero_mask else mask)
        return {"source": denormalize(src), "generated": denormalize(gen), "target": denormalize(tgt), "mask": mask}

    return run_inference(cfg, panels)


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

"""Multitask inference CLI of the port (counterpart of ``src/infer_multitask_multiclassloss.py``).

    python -m stain2stain_tpu_torch.infer_multitask_multiclassloss ckpt_path=<checkpoint dir> \
        model=conditional_flow_matching_multitask_multiclass data=paired_data_multiclass_seg_mask \
        +num_classes=2 data.data_dir=<tiles> [num_steps=50] [n_images=8] [device=cpu]

For the shared-encoder multitask models, binary (``model=conditional_flow_matching_multitask``)
and multiclass alike: each test tile is integrated through the flow head
(``num_steps``, 50 by default) and segmented by the mask head, on the CUDA
card unless ``device=cpu``. One source / generated / target / predicted mask
(/ true mask, when the batch has one) panel PNG a tile under
``<output_dir>/panels``; masks are gray, class ids clipped to [0, 1].
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

    def panels(task, prepared):
        src, tgt = prepared[0], prepared[1]
        gen, pred_mask = task.generate(src, num_steps=num_steps)
        out = {"source": denormalize(src), "generated": denormalize(gen), "target": denormalize(tgt),
               "pred_mask": pred_mask.to(torch.float32)}
        if len(prepared) > 2:
            out["gt_mask"] = prepared[2].to(torch.float32)
        return out

    return run_inference(cfg, panels)


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

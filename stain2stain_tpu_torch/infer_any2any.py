"""Any↔any multi-stain inference CLI of the port (counterpart of
``src/infer_any2any.py``).

    python -m stain2stain_tpu_torch.infer_any2any ckpt_path=<checkpoint dir> \
        model=class_conditional_flow_matching data=class_conditional_he_amyloid \
        num_steps=100 [device=cpu]

Each panel holds the source and its translation to every class, side by
side in class order, all from one ``generate_all_classes`` call a batch (the
panels carry no titles, so the JAX CLI's ``class_names`` has nothing to name).
"""

from __future__ import annotations

import os
from pathlib import Path

from .config import Config, config_main
from .inference import run_inference
from .ops.image import denormalize

REPO_ROOT = Path(__file__).resolve().parent.parent


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> Path:
    num_steps = int(cfg.get("num_steps", 100))

    def panels(task, prepared):
        src = prepared[0]
        all_cls = task.generate_all_classes(src, num_steps=num_steps)  # (num_classes, B, H, W, C)
        return {"source": denormalize(src), **{f"to_class_{c}": denormalize(x) for c, x in enumerate(all_cls)}}

    return run_inference(cfg, panels)


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

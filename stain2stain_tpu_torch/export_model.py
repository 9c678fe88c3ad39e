"""Export a checkpoint as a sealed serving program (counterpart of ``src/export_model.py``).

    python -m stain2stain_tpu_torch.export_model ckpt_path=<dir|.ckpt|.pt> model=... \
        num_steps=50 +batch=8 +image_size=256 +out=generator.pt2 [device=cpu]

Loads the task of ``cfg.model`` with the checkpoint's weights
(``inference.load_task``, on the CUDA card unless ``device=cpu``) and writes
one ``torch.export`` program with the weights baked in and the ODE sampler
inside it (``serving.export_generator``), plus its JSON sidecar. The default
``out`` is ``<output_dir>/generator.pt2``. ``serving.load_generator`` runs it
without any model code.
"""

from __future__ import annotations

import os
from pathlib import Path

from .config import Config, config_main
from .inference import load_task
from .serving import export_generator

REPO_ROOT = Path(__file__).resolve().parent.parent


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> Path:
    task = load_task(cfg)
    out = cfg.get("out") or str(Path(cfg["paths"]["output_dir"]) / "generator.pt2")
    net_cfg = cfg["model"].get("net") or {}
    dim = net_cfg.get("dim", (3, 256, 256))
    return export_generator(
        task,
        out,
        batch=int(cfg.get("batch", 8)),
        image_size=int(cfg.get("image_size", dim[-1])),
        num_steps=int(cfg.get("num_steps", 50)),
        in_channels=int(dim[0]),
    )


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

"""Whole-slide (any-size image) inference CLI of the port (counterpart of
``src/infer_wsi.py``).

    python -m stain2stain_tpu_torch.infer_wsi ckpt_path=<checkpoint dir> input=<img.png|.npy> \
        output=<out.png|.npy> num_steps=2 tile=256 overlap=32 wsi_batch=16 [device=cpu]

``input`` is an 8-bit RGB image file (PIL formats) or an (H, W, 3) uint8
``.npy``; ``output`` a ``.png`` or ``.npy`` (default ``<input>.translated.png``).
The image is tiled, translated batch by batch on the CUDA card unless
``device=cpu``, and feather-stitched.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .config import Config, config_main
from .inference import load_task
from .ops.image import denormalize_np, normalize_uint8_np
from .utils.pylogger import RankedLogger
from .wsi import make_tiled_generator, translate_large_image

log = RankedLogger(__name__, rank_zero_only=True)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _read_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("RGB"))
    if img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {img.shape}")
    return img.astype(np.uint8)


def _write_image(path: str, img01: np.ndarray) -> None:
    if path.endswith(".npy"):
        np.save(path, img01)
        return
    from PIL import Image

    Image.fromarray((np.clip(img01, 0.0, 1.0) * 255).astype(np.uint8)).save(path)


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config) -> str:
    tile, overlap = int(cfg.get("tile", 256)), int(cfg.get("overlap", 32))
    batch, num_steps = int(cfg.get("wsi_batch", 16)), int(cfg.get("num_steps", 2))
    src = _read_image(cfg["input"])
    log.info(f"Input {cfg['input']}: {src.shape[0]}x{src.shape[1]}, tile={tile} overlap={overlap}")
    gen = make_tiled_generator(load_task(cfg), num_steps=num_steps)
    out = translate_large_image(gen, normalize_uint8_np(src), tile=tile, overlap=overlap, batch_size=batch)
    out_path = cfg.get("output") or str(Path(cfg["input"]).with_suffix(".translated.png"))
    _write_image(out_path, denormalize_np(out))
    log.info(f"Wrote {out_path}")
    return out_path


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

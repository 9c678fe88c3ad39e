"""Serving CLI of the port: a long-lived stain-translation HTTP server.

Counterpart of ``src/serve.py``. Composes ``configs/infer.yaml`` with the
port's config code, builds the task of ``cfg.model`` (its class, velocity net
and solver; a ``model=class_conditional_flow_matching`` net serves every
target stain, ``target_class`` the default one), loads the weights from a
``.pt`` state dict, a reference Lightning ``.ckpt`` or a checkpoint directory
of the port's trainer, and serves on the CUDA card (``device=cpu`` to run on
the CPU)::

    python -m stain2stain_tpu_torch.serve ckpt_path=<.pt|.ckpt> port=8000 \
        num_steps=2 tile=256 overlap=32 wsi_batch=16

    curl -X POST --data-binary @slide.png -H 'Content-Type: image/png' \
        http://localhost:8000/translate -o translated.png

An Orbax checkpoint of the JAX package is first converted by
``scripts/torch_from_orbax.py`` in a process that has JAX.
"""

from __future__ import annotations

import os
from pathlib import Path

from .config import Config, config_main
from .inference import load_task
from .server import TranslationServer, serve_forever
from .utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

REPO_ROOT = Path(__file__).resolve().parent.parent


def build_server(cfg: Config) -> TranslationServer:
    """The server described by a composed ``infer.yaml`` config."""
    task = load_task(cfg)
    return TranslationServer(
        task,
        num_steps=int(cfg.get("num_steps", 2)),
        tile=int(cfg.get("tile", 256)),
        overlap=int(cfg.get("overlap", 32)),
        batch=int(cfg.get("wsi_batch", 16)),
        target_class=cfg.get("target_class"),
    )


@config_main(config_path="../configs", config_name="infer.yaml")
def main(cfg: Config):
    server = build_server(cfg)
    log.info(f"Generator ready: {server.info}")
    serve_forever(server, host=str(cfg.get("host", "0.0.0.0")), port=int(cfg.get("port", 8000)))


if __name__ == "__main__":
    os.environ.setdefault("PROJECT_ROOT", str(REPO_ROOT))
    main()

"""Tiny cells for the CPU tests: the flagship's configuration and traffic
files, at a width and size the CPU runs in seconds, in float32."""

from __future__ import annotations

import copy
from pathlib import Path

from benchmark.core import Cell, load_json, load_manifest

ROOT = Path(__file__).resolve().parents[2]

NET = {"dim": [3, 32, 32], "num_channels": 16, "num_res_blocks": 1, "channel_mult": [1, 2],
       "attention_resolutions": "16", "num_heads": 4, "num_head_channels": 8, "dropout": 0.1,
       "use_scale_shift_norm": True}
NET_OVERRIDES = ["model.net.dim=[3,32,32]", "model.net.num_channels=16", "model.net.num_res_blocks=1",
                 "model.net.channel_mult=[1,2]", "model.net.attention_resolutions='16'",
                 "model.net.num_head_channels=8"]


MASK_NET = dict(NET, dim=[4, 32, 32], out_channels=3, attention_resolutions=[2])
MASK_OVERRIDES = ["model.net.dim=[4,32,32]", "model.net.num_channels=16", "model.net.num_res_blocks=1",
                  "model.net.channel_mult=[1,2]", "model.net.attention_resolutions=[2]",
                  "model.net.num_head_channels=8"]


def cell(name: str) -> Cell:
    """The manifest's cell ``name`` cut to the tiny net, data and batch, f32 on the CPU."""
    full = Cell.from_manifest(ROOT, load_manifest(ROOT), name)
    config = copy.deepcopy(full.config)
    train = config["train"]
    masked = bool(train["data"].get("mask"))
    config["net"] = dict(MASK_NET if masked else NET)
    if masked:
        train["overrides"] = list(train["overrides"]) + [
            "trainer.precision=32", "data.batch_size=4", "data.image_size=32", "data.num_workers=1"] + MASK_OVERRIDES
    else:
        train["overrides"] = ["experiment=quality_real_256", "trainer.precision=32", "data.batch_size=4",
                              "data.image_size=32", "data.load_size=32", "data.num_workers=1"] + NET_OVERRIDES
    train["fused_conv"] = False
    train["data"] = {"n_train": 12, "n_val": 2, "n_test": 2, "size": 32, "seed": 0, "mask": masked}
    train["recipe"] = dict(train["recipe"], precision=32, batch_size=4, image_size=32)
    train["reference_rows"] = 2
    serve = config.get("serve")
    if serve:
        serve["overrides"] = list(serve["overrides"]) + NET_OVERRIDES
        serve.update(tile=32, overlap=8, wsi_batch=4)
    traffic = dict(full.traffic)
    if traffic["kind"] == "train":
        traffic.update(trace_steps=2)
    else:
        traffic.update(min_px=16, max_px=80, block=6, check_sample=3, trace_after_s=0.5, trace_seconds=0.5)
    return Cell(full.name, config, traffic, full.chips, full.end_to_end, full.per_layer)


def traffic_file(name: str) -> dict:
    return load_json(ROOT / "benchmark" / "traffic" / f"{name}.json")

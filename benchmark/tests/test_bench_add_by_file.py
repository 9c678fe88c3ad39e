"""A later change adds a configuration, a traffic mix, a per-layer metric
and a configuration of a new architecture (its plain reference a file of its
own) by adding files and manifest entries only: here in a throwaway tree
beside the repository's code, found by name and run on the CPU."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from benchmark import core
from benchmark.drivers.train import compose_recipe
from benchmark.tests import tiny

METRIC = '''"""warm_steps_seen: the steps the set-up ran before the window."""


def read(record):
    return float(record.counts["warm_steps"]) if "warm_steps" in record.counts else None
'''


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = tmp_path
    (root / "configs").symlink_to(tiny.ROOT / "configs")
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "reference").symlink_to(tiny.ROOT / "benchmark" / "reference")  # the ADM reference is there already
    config = tiny.cell("train.cfm-unet-256").config
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(config))
    traffic = dict(tiny.traffic_file("train"), warm_steps=2, trace_steps=1)
    (bench / "traffic" / "train-short.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "warm_steps_seen.py").write_text(METRIC)

    manifest = core.load_manifest(tiny.ROOT)
    manifest["configs"].append({"name": "tiny-new", "source": "https://arxiv.org/abs/2105.05233",
                                "file": "benchmark/configs/tiny-new.json", "reduced": [], "why": "a throwaway"})
    manifest["workloads"].append({"name": "train.tiny-new", "config": "tiny-new", "traffic": "train-short",
                                  "chips": 1, "why": "a throwaway"})
    for m in manifest["end_to_end"]:
        if m["name"] in ("train_tiles_per_s", "train_peak_mem_gib"):
            m["workloads"].append("train.tiny-new")
    manifest["per_layer"].append({"name": "warm_steps_seen", "unit": "steps", "better": "lower",
                                  "source": "program_counter", "layer": "trainer + data",
                                  "moves": "train_tiles_per_s", "workloads": ["train.tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = core.Cell.from_manifest(root, core.load_manifest(root), "train.tiny-new")
    assert cell.traffic["warm_steps"] == 2
    assert [m["name"] for m in cell.per_layer] == ["warm_steps_seen"]
    record = core.Record(cell=cell, seed=2**31 + 1, traced=True)
    core.driver(cell.traffic["kind"]).run(record, root, "cpu", 0.5, time.monotonic())
    line = core.result_line(record, {"platform": "cpu"})
    assert line["metrics"] == {"warm_steps_seen": {"value": 2.0, "unit": "steps"}}
    assert line["correct"] is True
    assert (bench / "cache").is_dir()


# ---------------------------------------------------------------- a new architecture

REFERENCE = """\'\'\'The plain reference of a patch transformer: patch embedding, a sinusoidal
time embedding added to every token, one pre-norm transformer block and a
linear unpatchify, no dropout. NCHW f32.\'\'\'

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.common import Ctx, conv, timestep_embedding


class Net(nn.Module):
    def __init__(self, channels, patch, width, heads):
        super().__init__()
        self.patch, self.width, self.heads = patch, width, heads
        self.embed = nn.Conv2d(channels, width, patch, stride=patch)
        self.time = nn.Linear(width, width)
        self.norm1 = nn.LayerNorm(width)
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)
        self.norm2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(nn.Linear(width, 2 * width), nn.GELU(approximate="tanh"),
                                 nn.Linear(2 * width, width))
        self.out_norm = nn.LayerNorm(width)
        self.out = nn.Linear(width, patch * patch * channels)
        self.dropout_layers = []

    def forward(self, t, x, ctx=None):
        ctx = ctx or Ctx()
        r = ctx.cast
        b, c, h, w = x.shape
        p, gh, gw = self.patch, h // self.patch, w // self.patch
        tokens = conv(self.embed, x, ctx).flatten(2).transpose(1, 2)
        tokens = tokens + conv(self.time, timestep_embedding(t, self.width), ctx)[:, None]
        q, k, v = conv(self.qkv, self.norm1(tokens), ctx).reshape(b, gh * gw, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        logits = r.out(r.inp(q) @ r.inp(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
        attended = r.out(r.inp(torch.softmax(logits, dim=-1)) @ r.inp(v))
        tokens = tokens + conv(self.proj, attended.transpose(1, 2).reshape(b, gh * gw, self.width), ctx)
        hidden = F.gelu(conv(self.mlp[0], self.norm2(tokens), ctx), approximate="tanh")
        tokens = tokens + conv(self.mlp[2], hidden, ctx)
        out = conv(self.out, self.out_norm(tokens), ctx).reshape(b, gh, gw, p, p, c)
        return out.permute(0, 5, 1, 3, 2, 4).reshape(b, c, h, w)


def build(net_cfg, device=None):
    with torch.device(device or "cpu"):
        return Net(int(net_cfg["dim"][0]), int(net_cfg["patch"]), int(net_cfg["width"]), int(net_cfg["heads"]))


def attention_shapes(net_cfg, size):
    heads, width = int(net_cfg["heads"]), int(net_cfg["width"])
    return [(heads, (size // int(net_cfg["patch"])) ** 2, width // heads)]
"""

PATCH_NET = {"dim": [3, 32, 32], "patch": 8, "width": 32, "heads": 2}
PROGRAM_NET = ("model.net={_target_: benchmark.tests.patch_transformer.PatchTransformer, "
               "dim: [3, 32, 32], patch: 8, width: 32, heads: 2}")


def _patch_transformer_tree(root):
    """A throwaway tree whose one new configuration names a reference file
    of its own, with a training and a serving cell; the repository's code
    and the program's config tree are found beside it."""
    (root / "configs").symlink_to(tiny.ROOT / "configs")
    bench = root / "benchmark"
    for sub in ("configs", "traffic", "reference"):
        (bench / sub).mkdir(parents=True)
    (bench / "reference" / "patch_transformer.py").write_text(REFERENCE)
    config = tiny.cell("serve.cfm-unet-256").config
    config.update(reference="benchmark/reference/patch_transformer.py", net=dict(PATCH_NET),
                  source="https://arxiv.org/abs/2212.09748")
    train, serve = config["train"], config["serve"]
    train["overrides"] = [o for o in train["overrides"] if not o.startswith("model.net.")] + [PROGRAM_NET]
    train["recipe"] = dict(train["recipe"], dropout=None)
    serve["overrides"] = [o for o in serve["overrides"] if not o.startswith("model.net.")] + [PROGRAM_NET]
    (bench / "configs" / "patch-transformer.json").write_text(json.dumps(config))
    (bench / "traffic" / "train-short.json").write_text(json.dumps(dict(tiny.traffic_file("train"), warm_steps=3)))
    serve_traffic = dict(tiny.traffic_file("serve-regions-c4"), min_px=16, max_px=80, block=6, check_sample=3)
    (bench / "traffic" / "serve-small.json").write_text(json.dumps(serve_traffic))

    manifest = core.load_manifest(tiny.ROOT)
    manifest["configs"].append({"name": "patch-transformer", "source": "https://arxiv.org/abs/2212.09748",
                                "file": "benchmark/configs/patch-transformer.json", "reduced": [],
                                "why": "a throwaway"})
    for kind, traffic in (("train", "train-short"), ("serve", "serve-small")):
        manifest["workloads"].append({"name": f"{kind}.patch-transformer", "config": "patch-transformer",
                                      "traffic": traffic, "chips": 1, "why": "a throwaway"})
    for m in manifest["end_to_end"]:
        if "workloads" in m and m["name"] in ("train_tiles_per_s", "train_peak_mem_gib"):
            m["workloads"].append("train.patch-transformer")
        elif "workloads" in m and m["name"].startswith("serve_"):
            m["workloads"].append("serve.patch-transformer")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def _unchanged_step(trainer, task):
    trainer.state.optimizer.step = lambda *a, **k: None


def _altered_answer(server):
    translate = server.translate

    def altered(img, target_class=None):
        out = translate(img, target_class)
        out[: out.shape[0] // 2] = np.clip(out[: out.shape[0] // 2] + 0.05, 0.0, 1.0)
        return out

    server.translate = altered


@pytest.mark.parametrize("workload,patch,correct", [
    ("train.patch-transformer", None, True),
    ("serve.patch-transformer", None, True),
    ("train.patch-transformer", _unchanged_step, False),
    ("serve.patch-transformer", _altered_answer, False),
], ids=["train", "serve", "train-unchanged-step", "serve-altered-answer"])
def test_new_architecture_enters_by_files_alone(tmp_path, workload, patch, correct):
    root = _patch_transformer_tree(tmp_path)
    cell = core.Cell.from_manifest(root, core.load_manifest(root), workload)
    assert cell.reference.__file__ == str((root / "benchmark" / "reference" / "patch_transformer.py").resolve())
    assert cell.reference.fused_convs(PATCH_NET, 32) == [] and not cell.reference.zeroed("out.weight")
    record = core.Record(cell=cell, seed=2**31 + 41, traced=False)
    seconds = 0.5 if workload.startswith("train") else 2.0
    core.driver(cell.traffic["kind"]).run(record, root, "cpu", seconds, time.monotonic(), patch=patch)
    line = core.result_line(record, {"platform": "cpu"})
    assert line["correct"] is correct, line["compared"]
    assert record.attempted > 0
    assert record.work["forward_flops_per_tile"] > 0
    if workload.startswith("train"):
        assert record.work["attention"] == [(2, 16, 16)] and record.work["resblock_convs"] == []
        if correct:
            assert max(c.value for c in record.checks) < 1e-4


def test_a_recipe_without_dropout_needs_a_net_without_it(tmp_path):
    cell = tiny.cell("train.cfm-unet-256")  # the ADM net states dropout 0.1
    cell.config["train"]["recipe"]["dropout"] = None
    with pytest.raises(ValueError, match="model.net.dropout"):
        compose_recipe(tiny.ROOT, cell.config, tmp_path, 1, "cpu")

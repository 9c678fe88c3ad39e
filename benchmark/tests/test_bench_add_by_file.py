"""A later change adds a configuration, a traffic mix and a per-layer metric
by adding files and manifest entries only: here in a throwaway tree beside
the repository's code, found by name and run on the CPU."""

from __future__ import annotations

import json
import time

from benchmark import core
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

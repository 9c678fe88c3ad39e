"""BENCHMARK.json against the contract's shape and name rules, and every
file it names found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.core import NAME, Cell, Record, load_manifest, metric_reader
from benchmark.tests.tiny import ROOT

MANIFEST = load_manifest(ROOT)
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_time():
    cells = 24  # the most a later PR may bring
    total = (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_config_is_used_and_every_pair_once():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_reports_setup_another_metric_and_a_layer(workload):
    cell = Cell.from_manifest(ROOT, MANIFEST, workload)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert (ROOT / "benchmark" / "drivers" / f"{cell.traffic['kind']}.py").is_file()


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_readers_load_and_find_nothing_in_an_empty_run(workload):
    cell = Cell.from_manifest(ROOT, MANIFEST, workload)
    record = Record(cell=cell, seed=1, traced=True)
    for m in cell.per_layer:
        assert metric_reader(ROOT, m["name"])(record) is None, m["name"]


LIMITS = {"train": {"loss_gap", "loss1_gap", "grad1_gap", "change_gap", "grad1_median_gap", "change_median_gap"},
          "serve": {"pixel_mean_gap", "pixel_max_gap"}}


def test_config_files_state_the_configuration():
    for c in MANIFEST["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in config["published"]
    for w in MANIFEST["workloads"]:
        cell = Cell.from_manifest(ROOT, MANIFEST, w["name"])
        assert set(cell.config["limits"]) & LIMITS[cell.traffic["kind"]]
        assert set(cell.config["limits"]) <= LIMITS["train"] | LIMITS["serve"]
        assert cell.traffic["kind"] in cell.config["control_precision"]


def test_files_under_paths_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "cache" in rel.split("/") or "__pycache__" in rel:
            continue
        assert PATH.match(rel), rel

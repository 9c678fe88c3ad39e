"""The plain reference against the program on the CPU at a tiny size: the
same net on the same weights, and whole runs of both drivers, whose
comparisons must read round-off alone."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import core, inputs
from benchmark.reference import adm
from benchmark.tests import tiny


def test_net_matches_the_program():
    from stain2stain_tpu_torch.models.unet import UNetModel

    net_cfg = tiny.NET
    program = UNetModel(dim=net_cfg["dim"], num_channels=16, num_res_blocks=1, channel_mult=(1, 2),
                        attention_resolutions="16", num_head_channels=8, dropout=0.1, device="cpu").eval()
    ref = adm.build(net_cfg)
    names = [(k, tuple(p.shape)) for k, p in program.named_parameters()]
    assert sorted(names) == sorted((k, tuple(p.shape)) for k, p in ref.named_parameters())
    weights = inputs.make_weights(names, 2**31 + 5, "cpu", adm.zeroed)
    program.load_state_dict(weights, strict=False)
    ref.load_state_dict(weights)
    x = torch.randn(3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([0.0, 0.3, 0.9])
    with torch.no_grad():
        want = program(t, x)
        got = ref(t, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float((want - got).abs().max()) < 1e-5 * max(1.0, float(want.abs().max()))


def test_dropout_mask_matches_the_program():
    from stain2stain_tpu_torch.ops.dropout import hash_mask

    shape = (4, 3, 5, 6)
    for seed in (0, 12345, 2**32 - 1):
        want = hash_mask(seed, shape, 0.1, torch.float32) > 0
        assert torch.equal(adm.dropout_keep(seed, shape, 0.1, 0, "cpu"), want)
        assert torch.equal(adm.dropout_keep(seed, (2, 3, 5, 6), 0.1, 2, "cpu"), want[2:])


@pytest.mark.parametrize("workload", ["train.cfm-unet-256", "serve.cfm-unet-256", "train.cfm-unet-mask-512"])
def test_whole_run_compares_to_round_off(workload):
    cell = tiny.cell(workload)
    record = core.Record(cell=cell, seed=2**31 + 77, traced=False)
    core.driver(cell.traffic["kind"]).run(record, tiny.ROOT, "cpu", 2.0, time.monotonic())
    values = {c.name: c.value for c in record.checks}
    assert record.attempted > 0 and record.failed == 0
    if workload.startswith("train"):
        assert values and max(values.values()) < 1e-4
        rates = [m["name"] for m in cell.end_to_end if m["unit"] == "tiles/s"]
        assert len(rates) == 1 and record.end_to_end[rates[0]] > 0
    else:
        assert values["pixel_max_gap"] <= 1.0 and values["pixel_mean_gap"] < 0.01
        assert record.counts["tile_rows"] > 0
        assert np.isfinite(record.end_to_end["serve_mpix_per_s"])


@pytest.mark.parametrize("workload", ["train.cfm-unet-256", "train.cfm-unet-mask-512"])
def test_traced_run_reports_the_cells_own_per_layer_metrics(workload):
    cell = tiny.cell(workload)
    record = core.Record(cell=cell, seed=2**31 + 78, traced=True)
    core.driver(cell.traffic["kind"]).run(record, tiny.ROOT, "cpu", 1.0, time.monotonic())
    line = core.result_line(record, {"platform": "cpu"})
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert [n for n in line["metrics"] if n.startswith("mfu.")] == [
        m["name"] for m in cell.per_layer if m["name"].startswith("mfu.")]
    assert line["correct"] is True


def test_traced_serve_window_waits_for_the_readers_count():
    # a traced stretch and a window far too short for ten requests: the trace
    # runs on, and the clients with it, until ten traced requests have ended
    from benchmark.core import metric_reader
    from benchmark.spans import trees

    cell = tiny.cell("serve.cfm-unet-256")
    cell.traffic.update(trace_after_s=0.05, trace_seconds=0.05)
    record = core.Record(cell=cell, seed=2**31 + 79, traced=True)
    core.driver(cell.traffic["kind"]).run(record, tiny.ROOT, "cpu", 0.2, time.monotonic())
    assert len({s.root for s in trees(record, "test", "serve.request")}) >= 10
    assert metric_reader(tiny.ROOT, "lock_wait_ms.serve")(record) is not None
    assert record.trace.window_s > 0.05
    assert all(c.ok for c in record.checks), record.checks

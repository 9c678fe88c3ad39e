"""The control: the reference in the precision next below the
configuration's, in the program's place. On the card at the cell's size it
fails the cell's limits; on the CPU at a tiny size it reads far above what
the program reads there."""

from __future__ import annotations

import pytest

from benchmark import control, core
from benchmark.tests import tiny

WORKLOADS = ["train.cfm-unet-256", "serve.cfm-unet-256", "train.cfm-unet-mask-512"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_far_above_round_off_on_the_cpu(workload):
    values = control.control(tiny.cell(workload), 2**31 + 9, tiny.ROOT, "cpu")
    if workload.startswith("train"):
        assert max(values.values()) > 1e-4  # the program reads about 1e-6 here
    else:
        assert values["pixel_mean_gap"] > 0.02


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_the_limits_on_the_card(card, workload):
    cell = core.Cell.from_manifest(tiny.ROOT, core.load_manifest(tiny.ROOT), workload)
    values = control.control(cell, 2**31 + 21, tiny.ROOT, card)
    limits = cell.config["limits"]
    assert any(values[k] > limits[k] for k in values if k in limits), values

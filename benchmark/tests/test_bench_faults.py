"""The harness sees each fault a cell can have: a whole run at a tiny size
on the CPU, the look for a card skipped, the timed path broken underneath,
and ``correct`` comes out false under the configuration's limits."""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import core
from benchmark.tests import tiny


def _unchanged_step(trainer, task):
    trainer.state.optimizer.step = lambda *a, **k: None


def _half_batch(trainer, task):
    full = task.loss_and_metrics

    def half(batch, generator=None, train=False, **kw):
        n = batch[0].shape[0] // 2
        return full(tuple(x[:n] for x in batch), generator, train=train, **kw)

    task.loss_and_metrics = half


def _altered_answer(server):
    translate = server.translate

    def altered(img, target_class=None):
        out = translate(img, target_class)
        out[: out.shape[0] // 2] = np.clip(out[: out.shape[0] // 2] + 0.05, 0.0, 1.0)
        return out

    server.translate = altered


@pytest.mark.parametrize("workload,patch", [
    ("train.cfm-unet-256", _unchanged_step),
    ("train.cfm-unet-256", _half_batch),
    ("serve.cfm-unet-256", _altered_answer),
    ("train.cfm-unet-mask-512", _unchanged_step),
    ("train.cfm-unet-mask-512", _half_batch),
], ids=["unchanged-step", "half-batch", "altered-answer", "mask-unchanged-step", "mask-half-batch"])
def test_fault_is_not_correct(workload, patch):
    cell = tiny.cell(workload)
    record = core.Record(cell=cell, seed=2**31 + 3, traced=False)
    core.driver(cell.traffic["kind"]).run(record, tiny.ROOT, "cpu", 1.0, time.monotonic(), patch=patch)
    line = core.result_line(record, {"platform": "cpu"})
    assert line["correct"] is False, line["compared"]

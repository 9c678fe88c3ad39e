"""``ln_modulate_roofline`` on synthetic traced records of the DiT cell: the
share its formula gives, and None with a note where the program has no such
kernel or launched it another number of times (the parent of the kernels)."""

from __future__ import annotations

import pytest

from benchmark.core import Cell, Record, load_manifest, metric_reader
from benchmark.trace import Trace
from benchmark.tests.tiny import ROOT

CELL = "train.dit-xl-2-512"
KERNELS = {"void (anonymous namespace)::ln_modulate_fwd_kernel<float, __nv_bfloat16, 9>(float const*)": 0.0,
           "void (anonymous namespace)::ln_modulate_bwd_kernel<float, __nv_bfloat16, 9>(float const*)": 0.0,
           "(anonymous namespace)::ln_modulate_bwd_sum_kernel(float const*)": 0.0}


def _record(by_kernel: dict, launches: dict, precision: str = "bfloat16") -> Record:
    cell = Cell.from_manifest(ROOT, load_manifest(ROOT), CELL)
    record = Record(cell=cell, seed=2**31 + 5, traced=True)
    record.trace = Trace(window_s=4.0, busy_s=3.9, by_kernel=dict(by_kernel, nvjet_tst_192x8_64x4=1.0))
    record.counts.update(traced_steps=8, batch=32, launches=launches)
    record.work.update(precision=precision)
    return record


def _least_s(precision: str) -> float:
    """8 steps × 57 calls × (32 · 1024 · 1152 elements × (x + y + dy + x + dx bytes)) at 3.35 TB/s."""
    y = 2 if precision == "bfloat16" else 4
    return 8 * 57 * 32 * 1024 * 1152 * (4 + y + y + 4 + 4) / 3.35e12


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_reads_the_least_time_over_the_kernels_device_time(precision):
    least = _least_s(precision)
    times = dict(zip(KERNELS, (0.3 * least, 0.6 * least, 0.1 * least)))  # the three kernels: 1.0 × least, 100 %
    record = _record({name: 2 * t for name, t in times.items()}, {"ln_modulate_fwd": 456, "ln_modulate_bwd": 456},
                     precision)
    assert metric_reader(ROOT, "ln_modulate_roofline")(record) == pytest.approx(50.0)


@pytest.mark.parametrize("by_kernel,launches", [
    ({}, {"K1-fwd": 224, "K1-bwd": 224}),  # the parent: no such kernel, no such counter
    (dict.fromkeys(KERNELS, 1e-3), {"ln_modulate_fwd": 455, "ln_modulate_bwd": 456}),
    ({}, {"ln_modulate_fwd": 456, "ln_modulate_bwd": 456}),
], ids=["parent", "launch-count", "no-kernel-in-trace"])
def test_finds_nothing_without_the_kernels(by_kernel, launches, capsys):
    assert metric_reader(ROOT, "ln_modulate_roofline")(_record(by_kernel, launches)) is None
    assert "ln_modulate_roofline left out" in capsys.readouterr().err

"""The DiT configuration (``configs/dit-xl-2-512.json``, its reference
``reference/dit.py``) cut to a tiny DiT in a throwaway tree, run through the
real training driver on the CPU: ``correct`` true, and false with a fault
planted; its per-layer readers that need no card read the traced run."""

from __future__ import annotations

import copy
import json
import time

import pytest

from benchmark import core
from benchmark.tests import tiny

TINY_NET = {"dim": [3, 32, 32], "patch_size": 8, "hidden_size": 144, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0}
PROGRAM_NET = ("model.net={_target_: stain2stain_tpu_torch.models.dit.DiT, dim: [3, 32, 32], patch_size: 8, "
               "hidden_size: 144, depth: 2, num_heads: 2, mlp_ratio: 4.0}")
CELL = "train.dit-xl-2-512"


def _tiny_dit_tree(root):
    """The manifest with the DiT configuration cut to the tiny net, data and
    batch, f32, beside the repository's code and the program's config tree."""
    (root / "configs").symlink_to(tiny.ROOT / "configs")
    bench = root / "benchmark"
    bench.mkdir()
    for sub in ("reference", "traffic", "metrics"):
        (bench / sub).symlink_to(tiny.ROOT / "benchmark" / sub)
    (bench / "configs").mkdir()
    manifest = core.load_manifest(tiny.ROOT)
    entry = core.find(manifest["configs"], "dit-xl-2-512", "config")
    config = copy.deepcopy(core.load_json(tiny.ROOT / entry["file"]))
    train = config["train"]
    assert any(o.startswith("model.net={_target_: stain2stain_tpu_torch.models.dit.DiT") for o in train["overrides"])
    train["overrides"] = ["experiment=quality_real_256", "trainer.precision=32", "data.batch_size=4",
                          "data.image_size=32", "data.load_size=32", "data.num_workers=1", "model.optimizer.lr=1e-4",
                          PROGRAM_NET]
    train["data"] = {"n_train": 12, "n_val": 2, "n_test": 2, "size": 32, "seed": 0}
    train["recipe"] = dict(train["recipe"], precision=32, batch_size=4, image_size=32)
    train["reference_rows"] = 2
    config["net"] = dict(TINY_NET)
    (bench / "configs" / "dit-xl-2-512.json").write_text(json.dumps(config))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


def _unchanged_step(trainer, task):
    trainer.state.optimizer.step = lambda *a, **k: None


def _half_batch(trainer, task):
    full = task.loss_and_metrics

    def half(batch, generator=None, train=False, **kw):
        n = batch[0].shape[0] // 2
        return full(tuple(x[:n] for x in batch), generator, train=train, **kw)

    task.loss_and_metrics = half


@pytest.mark.parametrize("patch,correct", [(None, True), (_unchanged_step, False), (_half_batch, False)],
                         ids=["dit", "dit-unchanged-step", "dit-half-batch"])
def test_dit_cell_runs_through_the_driver(tmp_path, patch, correct):
    root = _tiny_dit_tree(tmp_path)
    cell = core.Cell.from_manifest(root, core.load_manifest(root), CELL)
    assert cell.reference.__file__ == str((tiny.ROOT / "benchmark" / "reference" / "dit.py").resolve())
    record = core.Record(cell=cell, seed=2**31 + 59, traced=patch is None)
    core.driver(cell.traffic["kind"]).run(record, root, "cpu", 0.5, time.monotonic(), patch=patch)
    line = core.result_line(record, {"platform": "cpu"})
    assert line["correct"] is correct, line["compared"]
    assert set(line["compared"]) == set(cell.config["limits"])
    if correct:
        assert record.work["attention"] == [(2, 16, 72)] * 2 and record.work["resblock_convs"] == []
        assert max(c.value for c in record.checks) < 1e-4  # f32 on the CPU: the order of sums alone
        # no card: the device readers find nothing; the host clock and the spans read
        assert set(line["metrics"]) == {"mfu.train_dit", "dit_host_share.train_dit", "data_share.train_dit"}
        assert 0 < line["metrics"]["dit_host_share.train_dit"]["value"] < 100
        assert 0 < line["metrics"]["data_share.train_dit"]["value"] < 100

"""The port's first-party sweeper against the JAX package's, on the CPU
(mirrors ``tests/test_sweep.py``).

- The parameter grammar, parsed alike by both.
- 40 proposals of ``TPESampler(seed=0, n_startup_trials=8)`` on the JAX
  tests' quadratic, and a categorical-and-float study, equal to JAX's bit
  for bit.
- Failing trials, the JSONL journal and its resume, ``n_jobs`` and
  constant-liar batches, ``run_study``'s overrides.
- ``-m hparams_search=mnist_optuna experiment=example trainer=cpu`` in
  process: a 2-trial study over the MNIST template.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import numpy as np
import pytest

from stain2stain_tpu import sweep as jsweep
from stain2stain_tpu_torch import sweep as tsweep
from stain2stain_tpu_torch.config import Config
from stain2stain_tpu_torch.sweep import ParamSpace, Sweeper, TPESampler, parse_param, run_study

REPO_ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("spec", ["interval(0.0001, 0.1)", "choice(32, 64, 128, 256)", "range(0, 10, 2)",
                                  "int(interval(1, 9))", "choice(adam, sgd)", [1, "a"]])
def test_param_grammar_matches_jax(spec):
    got, ref = parse_param(spec), jsweep.parse_param(spec)
    assert (got.kind, got.lo, got.hi, got.choices) == (ref.kind, ref.lo, ref.hi, ref.choices)


def test_param_grammar():
    p = parse_param("interval(0.0001, 0.1)")
    assert p.kind == "float" and p.lo == pytest.approx(1e-4) and p.hi == pytest.approx(0.1)
    assert parse_param("choice(32, 64, 128, 256)").choices == (32, 64, 128, 256)
    assert parse_param("range(0, 10, 2)").choices == (0, 2, 4, 6, 8)
    assert parse_param("int(interval(1, 9))").kind == "int"
    assert parse_param("choice(adam, sgd)").choices == ("adam", "sgd")
    with pytest.raises(ValueError):
        parse_param("gaussian(0, 1)")


def _proposals(sampler, spaces, objective, n: int, direction: str = "minimize") -> list:
    history = []
    for _ in range(n):
        a = sampler.suggest(spaces, history, direction)
        history.append((a, objective(a)))
    return history


def test_tpe_proposals_match_jax_bit_for_bit():
    """The same seed and objective values: the same 40 proposals as JAX's sampler."""
    def quadratic(a):
        return (a["x"] - 2.0) ** 2

    got = _proposals(TPESampler(seed=0, n_startup_trials=8), {"x": ParamSpace("float", lo=-5.0, hi=5.0)},
                     quadratic, 40)
    ref = _proposals(jsweep.TPESampler(seed=0, n_startup_trials=8),
                     {"x": jsweep.ParamSpace("float", lo=-5.0, hi=5.0)}, quadratic, 40)
    assert got == ref
    # TPE leaves pure random (a TPE that never leaves startup) behind on the quadratic
    rand = _proposals(TPESampler(seed=0, n_startup_trials=1000), {"x": ParamSpace("float", lo=-5.0, hi=5.0)},
                      quadratic, 40)
    assert min(v for _, v in got) <= min(v for _, v in rand) + 1e-9


def test_sweeper_study_matches_jax():
    params = {"lr": "interval(0.001, 1.0)", "width": "choice(16, 32, 64)", "depth": "int(interval(1, 6))"}

    def objective(a):
        return -abs(a["lr"] - 0.1) + (0.5 if a["width"] == 64 else 0.0) - 0.01 * a["depth"]

    studies = {}
    for side, mod in (("port", tsweep), ("jax", jsweep)):
        seen = []
        sweeper = mod.Sweeper(direction="maximize", n_trials=25, sampler=mod.TPESampler(seed=3, n_startup_trials=8),
                              params=params)
        best = sweeper.optimize(lambda a: seen.append(dict(a)) or objective(a))
        studies[side] = (best, seen)
    assert studies["port"] == studies["jax"]
    best_val, best_params = studies["port"][0]
    assert best_params["width"] == 64 and abs(best_params["lr"] - 0.1) < 0.4


def test_sweeper_survives_failing_trials():
    calls = {"n": 0}

    def objective(a):
        calls["n"] += 1
        if calls["n"] % 2:
            raise RuntimeError("boom")
        return a["x"]

    sweeper = Sweeper(direction="maximize", n_trials=10, sampler=TPESampler(seed=1, n_startup_trials=4),
                      params={"x": "interval(0, 1)"})
    best_val, _ = sweeper.optimize(objective)
    assert calls["n"] == 10 and np.isfinite(best_val) and 0 <= best_val <= 1


def test_run_study_applies_overrides():
    cfg = Config({
        "optimized_metric": "score",
        "sweeper": {
            "_target_": "stain2stain_tpu.sweep.Sweeper",  # the configs' name, mapped onto the port
            "direction": "maximize",
            "n_trials": 6,
            "sampler": {"_target_": "stain2stain_tpu.sweep.TPESampler", "seed": 0, "n_startup_trials": 3},
            "params": {"model.lr": "interval(0, 1)"},
        },
        "model": {"lr": 0.5},
    })
    seen = []

    def task(trial_cfg):
        lr = trial_cfg["model"]["lr"]
        seen.append(lr)
        return {"score": 1.0 - abs(lr - 0.3)}

    best = run_study(cfg, task)
    assert len(seen) == 6 and cfg["model"]["lr"] == 0.5  # each trial edits a copy
    assert best == pytest.approx(max(1.0 - abs(v - 0.3) for v in seen))
    with pytest.raises(ValueError, match="optimized_metric"):
        run_study(Config({"sweeper": cfg["sweeper"].to_container()}), task)


def test_sweeper_storage_resume(tmp_path):
    journal = tmp_path / "study.jsonl"
    calls = []

    def objective(a):
        calls.append(a["x"])
        if len(calls) == 3:
            raise KeyboardInterrupt  # an interrupted sweep
        return (a["x"] - 0.25) ** 2

    sw = Sweeper(direction="minimize", n_trials=6, storage=str(journal),
                 sampler=TPESampler(seed=0, n_startup_trials=2), params={"x": "interval(0, 1)"})
    with pytest.raises(KeyboardInterrupt):
        sw.optimize(objective)
    assert len(calls) == 3 and len(journal.read_text().strip().splitlines()) == 2

    calls2 = []

    def objective2(a):
        calls2.append(a["x"])
        return (a["x"] - 0.25) ** 2

    sw2 = Sweeper(direction="minimize", n_trials=6, storage=str(journal),
                  sampler=TPESampler(seed=1, n_startup_trials=2), params={"x": "interval(0, 1)"})
    best_val, _ = sw2.optimize(objective2)
    assert len(calls2) == 4
    records = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["trial"] for r in records] == list(range(6))
    assert best_val == pytest.approx(min((v - 0.25) ** 2 for v in calls[:2] + calls2))
    # RDB URLs: three slashes before a relative path, four before an absolute one
    assert Sweeper(storage=f"sqlite:///{tmp_path}/study.db")._journal_path() == tmp_path / "study.db.jsonl"
    assert Sweeper(storage="sqlite:///study.db")._journal_path() == Path("study.db.jsonl")


def test_sweeper_n_jobs_runs_concurrently():
    active, peak, lock = [0], [0], threading.Lock()
    barrier = threading.Barrier(3, timeout=30)

    def objective(a):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        barrier.wait()  # the 3 trials of a batch are in flight together
        with lock:
            active[0] -= 1
        return a["x"]

    sw = Sweeper(direction="minimize", n_trials=6, n_jobs=3, sampler=TPESampler(seed=0, n_startup_trials=10),
                 params={"x": "interval(0, 1)"})
    best_val, _ = sw.optimize(objective)
    assert peak[0] == 3 and np.isfinite(best_val)


def test_batch_proposals_match_jax_and_spread_by_constant_liar():
    """Past the startup trials a batch of 4 does not collapse onto one point:
    in-flight assignments enter the history at the mean of the values so far.
    The batches equal JAX's."""
    proposals = {}
    for side, mod in (("port", tsweep), ("jax", jsweep)):
        seen, lock = [], threading.Lock()

        def objective(a, seen=seen, lock=lock):
            with lock:
                seen.append(a["x"])
            return (a["x"] - 0.3) ** 2

        mod.Sweeper(direction="minimize", n_trials=24, n_jobs=4, sampler=mod.TPESampler(seed=0, n_startup_trials=8),
                    params={"x": "interval(0, 1)"}).optimize(objective)
        proposals[side] = [sorted(seen[i:i + 4]) for i in range(0, 24, 4)]
    assert proposals["port"] == proposals["jax"]
    assert max(max(b) - min(b) for b in proposals["port"][2:]) > 1e-3


def test_mnist_sweep_through_the_entry_point(tmp_path, monkeypatch):
    """``-m hparams_search=mnist_optuna experiment=example trainer=cpu
    sweeper.n_trials=2``: two trials, each a training run; the study's result
    is its best ``val/acc_best``, and the journal holds both trials."""
    from stain2stain_tpu_torch.train import main

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    journal = tmp_path / "study.jsonl"
    (best,) = main(["-m", "hparams_search=mnist_optuna", "experiment=example", "trainer=cpu",
                    "sweeper.n_trials=2", "trainer.limit_train_batches=2", "trainer.limit_val_batches=2",
                    "trainer.min_epochs=1", "trainer.max_epochs=1", f"+sweeper.storage={journal}",
                    "extras.print_config=false"])
    records = [json.loads(line) for line in journal.read_text().splitlines()]
    assert [r["trial"] for r in records] == [0, 1]
    assert set(records[0]["params"]) == {"model.optimizer.lr", "data.batch_size", "model.net.lin1_size",
                                         "model.net.lin2_size", "model.net.lin3_size"}
    assert best == max(r["value"] for r in records) and 0.0 <= best <= 1.0

"""The port's loggers, ``wandb-artifact://`` resume, profiler trace and
running-best metrics against the JAX package's, on the CPU.

- Each service logger (wandb, mlflow, neptune, comet, aim) without its
  client: the same JSONL records as JAX's for the same calls, the same
  warning, the same class name.
- The offline ``log_model`` → ``wandb-artifact://`` round trip, a missing
  artifact, plain paths passing through, and the client branches driven by
  a fake ``wandb`` module (mirrors ``tests/test_artifact_roundtrip.py``).
- ``TensorBoardLogger`` writes an event file (tensorboardX).
- ``logger=wandb`` and ``logger=many_loggers`` compose and instantiate in
  both packages with the same loggers.
- ``experiment=smoke_synthetic trainer=cpu logger=wandb``, then a run from
  ``ckpt_path=wandb-artifact://…`` that goes on from its step and weights.
- ``+trainer.profiler=jax`` writes a trace under ``…/profile``; ``simple``
  prints its line (mirrors ``tests/test_train.py``).
- ``_track_best`` against JAX's on one scripted sequence of val metrics.
"""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from src.train import _resolve_ckpt_path as jax_resolve_ckpt_path
from stain2stain_tpu.config import compose as jax_compose
from stain2stain_tpu.training import loggers as jloggers
from stain2stain_tpu.training.trainer import Trainer as JaxTrainer
from stain2stain_tpu.utils import instantiate_loggers as jax_instantiate_loggers
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.train import _resolve_ckpt_path, train
from stain2stain_tpu_torch.training import Trainer, loggers
from stain2stain_tpu_torch.utils.utils import instantiate_loggers

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = REPO_ROOT / "configs"

SERVICES = ["WandbLogger", "MLFlowLogger", "NeptuneLogger", "CometLogger", "AimLogger"]


@pytest.fixture(autouse=True)
def no_tracking_clients(monkeypatch):
    """Each test runs as on a machine without the services' clients (the
    client tests install a fake ``wandb``): a real client would log in."""
    for name in ("wandb", "mlflow", "neptune", "comet_ml", "aim"):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.fixture()
def ckpt_dir(tmp_path):
    d = tmp_path / "ckpt" / "last"
    d.mkdir(parents=True)
    (d / "state.json").write_text(json.dumps({"step": 7}))
    (d / "weights.bin").write_bytes(b"\x00" * 64)
    return d


def _jsonl(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("cls", SERVICES)
def test_service_loggers_write_the_jax_records(cls, tmp_path, monkeypatch, ckpt_dir):
    monkeypatch.setenv("WANDB_CACHE_DIR", str(tmp_path / "cache"))
    records = {}
    for side, module in (("jax", jloggers), ("port", loggers)):
        with pytest.warns(UserWarning, match="is not installed; .* degrades to a local JSONL file"):
            logger = getattr(module, cls)(save_dir=str(tmp_path / side), project="stain2stain", name="runA")
        logger.log_hyperparams({"lr": 1e-3, "net": {"width": 8}})
        logger.log_metrics({"train/loss": np.float32(0.5), "val/acc": 1}, step=3)
        logger.log_model(str(ckpt_dir), {"epoch": 2, "val/loss": 0.25})
        logger.finalize()
        (path,) = (tmp_path / side).rglob("metrics.jsonl")
        records[side] = (type(logger).__name__, logger.name, path.relative_to(tmp_path / side), _jsonl(path))
    assert records["port"] == records["jax"]
    assert records["port"][3][-1]["artifact_ref"] == "stain2stain/model-runA:latest"


def test_log_model_then_resolve_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_CACHE_DIR", str(tmp_path / "wandb_cache"))
    with pytest.warns(UserWarning):
        logger = loggers.WandbLogger(save_dir=str(tmp_path / "logs"), project="stain2stain", name="runA")
    d = tmp_path / "ckpt" / "best"
    d.mkdir(parents=True)
    (d / "state.json").write_text(json.dumps({"step": 3}))
    logger.log_model(str(d), {"epoch": 3, "val/loss": 0.5})
    ref = logger.artifact_ref()
    assert ref == "stain2stain/model-runA:latest"
    resolved = _resolve_ckpt_path(f"wandb-artifact://{ref}")
    assert resolved == jax_resolve_ckpt_path(f"wandb-artifact://{ref}")
    assert json.loads((Path(resolved) / "state.json").read_text())["step"] == 3

    # a new log_model replaces the copy (log_model: all → latest tracks the newest)
    (d / "state.json").write_text(json.dumps({"step": 9}))
    logger.log_model(str(d))
    assert json.loads((Path(_resolve_ckpt_path(f"wandb-artifact://{ref}")) / "state.json").read_text())["step"] == 9
    # a file checkpoint is mirrored into the directory
    f = tmp_path / "model.pt"
    f.write_bytes(b"\x01" * 8)
    logger.log_model(str(f))
    assert (Path(_resolve_ckpt_path(f"wandb-artifact://{ref}")) / "model.pt").read_bytes() == b"\x01" * 8
    logger.finalize()
    jsonl = (tmp_path / "logs" / "wandb" / "metrics.jsonl").read_text()
    assert "model_artifact" in jsonl and ref in jsonl


def test_resolve_missing_artifact_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_CACHE_DIR", str(tmp_path / "empty_cache"))
    with pytest.raises(FileNotFoundError, match="wandb artifact"):
        _resolve_ckpt_path("wandb-artifact://stain2stain/model-missing:latest")


def test_plain_paths_pass_through(ckpt_dir):
    assert _resolve_ckpt_path(str(ckpt_dir)) == str(ckpt_dir)
    assert _resolve_ckpt_path(None) is None


class _FakeArtifact:
    """wandb.Artifact and the API's artifact handle."""

    def __init__(self, name, type=None, metadata=None):
        self.name, self.type, self.metadata = name, type, metadata or {}
        self.dirs, self.files, self.aliases = [], [], []

    def add_dir(self, path):
        self.dirs.append(path)

    def add_file(self, path):
        self.files.append(path)

    def download(self):
        return self.dirs[0] if self.dirs else str(Path(self.files[0]).parent)


class _FakeRun:
    def __init__(self, **kw):
        self.id = "fakerun01"
        self.kw = kw
        self.logged: list[tuple[dict, int]] = []
        self.artifacts: list[_FakeArtifact] = []
        self.finished = False

    def log(self, metrics, step=None):
        self.logged.append((metrics, step))

    def log_artifact(self, artifact, aliases=()):
        artifact.aliases = list(aliases)
        self.artifacts.append(artifact)

    def finish(self):
        self.finished = True


def _install_fake_wandb(monkeypatch):
    """A stand-in ``wandb`` module, so the client branches run."""
    fake = types.ModuleType("wandb")
    fake.runs = []
    fake.registry = {}

    def init(**kw):
        run = _FakeRun(**kw)
        fake.runs.append(run)
        return run

    class Api:
        def artifact(self, ref):
            return fake.registry[ref]

    fake.init, fake.Artifact, fake.Api = init, _FakeArtifact, Api
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return fake


def test_wandb_client_branch_log_model(tmp_path, monkeypatch, ckpt_dir):
    fake = _install_fake_wandb(monkeypatch)
    monkeypatch.setenv("WANDB_CACHE_DIR", str(tmp_path / "cache"))
    logger = loggers.WandbLogger(save_dir=str(tmp_path / "logs"), project="stain2stain", name="runB", offline=True)
    assert logger._client is fake.runs[0]
    assert fake.runs[0].kw == {"project": "stain2stain", "dir": str(tmp_path / "logs"), "mode": "offline",
                               "config": None, "name": "runB"}
    logger.log_metrics({"train/loss": torch.tensor(0.25)}, step=10)
    assert fake.runs[0].logged == [({"train/loss": 0.25}, 10)]
    logger.log_model(str(ckpt_dir), {"epoch": 7})
    (art,) = fake.runs[0].artifacts
    assert art.name == "model-runB" and art.type == "model" and art.metadata == {"epoch": 7}
    assert art.aliases == ["latest"] and art.dirs == [str(ckpt_dir)]
    assert not (tmp_path / "cache").exists()  # uploaded, not mirrored
    logger.finalize()
    assert fake.runs[0].finished


def test_wandb_client_branch_resolve_artifact(monkeypatch, ckpt_dir):
    fake = _install_fake_wandb(monkeypatch)
    art = _FakeArtifact("model-runC", type="model")
    art.add_dir(str(ckpt_dir))
    fake.registry["stain2stain/model-runC:latest"] = art
    assert _resolve_ckpt_path("wandb-artifact://stain2stain/model-runC:latest") == str(ckpt_dir)


def test_tensorboard_logger_writes_an_event_file(tmp_path):
    logger = loggers.TensorBoardLogger(save_dir=str(tmp_path), name="tb")
    logger.log_hyperparams({"lr": 1e-3})
    logger.log_metrics({"train/loss": torch.tensor(0.5)}, step=1)
    logger.log_images("val", {"source": np.full((2, 4, 4, 3), 0.5, np.float32)}, step=1)
    logger.finalize()
    (event,) = (tmp_path / "tb").glob("events.out.tfevents.*")
    assert event.stat().st_size > 0


@pytest.mark.parametrize("group", ["wandb", "many_loggers"])
def test_logger_configs_compose_and_instantiate_as_jax(group, tmp_path, monkeypatch):
    monkeypatch.setenv("WANDB_CACHE_DIR", str(tmp_path / "cache"))
    built = {}
    for side, (compose_fn, inst) in {"jax": (jax_compose, jax_instantiate_loggers),
                                     "port": (compose, instantiate_loggers)}.items():
        cfg = compose_fn(CONFIG_DIR, "train.yaml", ["experiment=smoke_synthetic", f"logger={group}"])
        cfg["runtime"] = {"output_dir": str(tmp_path / side), "cwd": str(tmp_path)}
        with pytest.warns(UserWarning, match="wandb is not installed"):
            objects = inst(cfg.get("logger"))
        built[side] = [(type(lg).__name__, lg.name) for lg in objects]
        for lg in objects:
            lg.finalize()
    assert built["port"] == built["jax"]
    assert ("WandbLogger", "wandb") in built["port"]


def _cfg(tmp_path: Path, extra=(), out: str = "out"):
    overrides = ["experiment=smoke_synthetic", "trainer=cpu", f"data.data_dir={tmp_path}/synthetic", *extra]
    cfg = compose(CONFIG_DIR, "train.yaml", overrides)
    (tmp_path / out).mkdir(exist_ok=True)
    cfg["runtime"] = {"output_dir": str(tmp_path / out), "cwd": str(tmp_path)}
    cfg["extras"]["print_config"] = False
    return cfg


def test_wandb_run_resumes_from_its_artifact(tmp_path, monkeypatch):
    """``logger=wandb`` trains, logs its best checkpoint and, after ``fit``
    has finalized the logger, the test metrics (the JAX package's sink
    raises on them); a second run from ``ckpt_path=wandb-artifact://…``
    starts from that checkpoint's weights and goes on from its step."""
    monkeypatch.setenv("WANDB_CACHE_DIR", str(tmp_path / "cache"))
    wandb = ["logger=wandb", "logger.wandb.name=smoke", "trainer.max_epochs=1", "test=true"]
    with pytest.warns(UserWarning, match="wandb is not installed"):
        _, first = train(_cfg(tmp_path, wandb, out="first"))
    assert first["trainer"].global_step == 2
    records = _jsonl(tmp_path / "first" / "wandb" / "metrics.jsonl")
    assert any("train/loss" in r for r in records) and "test/loss" in records[-1]
    (artifact,) = [r for r in records if "model_artifact" in r]
    assert artifact["artifact_ref"] == "stain2stain/model-smoke:latest"
    cached = tmp_path / "cache" / "stain2stain_model-smoke_latest"
    assert (cached / "state.pt").is_file() and (cached / "meta.json").is_file()

    cfg = _cfg(tmp_path, wandb[:-2] + ["trainer.max_epochs=2", "test=false"], out="resumed")
    cfg["ckpt_path"] = "wandb-artifact://stain2stain/model-smoke:latest"
    cfg["callbacks"]["snapshot"] = {"_target_": f"{__name__}._snapshot_factory"}
    _SNAPSHOTS.clear()
    # read now: the resumed run logs its own best checkpoint under the same reference
    saved = torch.load(cached / "state.pt", map_location="cpu", weights_only=True)["model"]
    with pytest.warns(UserWarning, match="wandb is not installed"):
        _, resumed = train(cfg)
    assert resumed["trainer"].current_epoch == 1 and resumed["trainer"].global_step == 4
    (start,) = _SNAPSHOTS
    assert set(start) == set(saved) and all(torch.equal(start[k], saved[k]) for k in saved)


_SNAPSHOTS: list = []


def _snapshot_factory():
    """A callback (built from the config by ``_target_``) that keeps the net's
    weights at each train epoch's start."""
    from stain2stain_tpu_torch.training import Callback

    class Snapshot(Callback):
        def on_train_epoch_start(self, trainer, task):
            _SNAPSHOTS.append({k: v.detach().clone() for k, v in task.net.state_dict().items()})

    return Snapshot()


def test_profiler_simple_and_jax(tmp_path, capsys):
    train(_cfg(tmp_path, ["logger=csv", "trainer.max_epochs=1", "test=false", "+trainer.profiler=simple",
                          "trainer.limit_train_batches=2"]))
    assert "[profiler] train_step mean" in capsys.readouterr().out
    train(_cfg(tmp_path, ["logger=csv", "trainer.max_epochs=1", "test=false", "+trainer.profiler=jax",
                          "trainer.limit_train_batches=1"]))
    (trace,) = (tmp_path / "out" / "profile").glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


class _Recorder:
    """The two attributes ``_track_best`` reads and writes."""

    def __init__(self):
        self.callback_metrics: dict = {}
        self.logged: list = []

    def log_metrics(self, metrics: dict) -> None:
        self.callback_metrics.update({k: float(v) for k, v in metrics.items()})
        self.logged.append(dict(metrics))


def test_track_best_matches_jax():
    task = types.SimpleNamespace(track_best={"val/acc": ("max", "val/acc_best"),
                                             "val/loss": ("min", "val/loss_best"),
                                             "val/absent": ("max", "val/absent_best")})
    sequence = [{"val/acc": 0.5, "val/loss": 1.0}, {"val/acc": 0.75, "val/loss": 1.25},
                {"val/acc": 0.25, "val/loss": 0.5}, {"val/acc": 0.75, "val/loss": 0.75}]
    logged = {}
    for side, track_best in (("jax", JaxTrainer._track_best), ("port", Trainer._track_best)):
        rec = _Recorder()
        for metrics in sequence:
            rec.log_metrics(metrics)
            track_best(rec, task)
        logged[side] = rec.logged
    assert logged["port"] == logged["jax"]
    assert [r["val/acc_best"] for r in logged["port"] if "val/acc_best" in r] == [0.5, 0.75, 0.75, 0.75]
    assert [r["val/loss_best"] for r in logged["port"] if "val/loss_best" in r] == [1.0, 1.0, 0.5, 0.5]

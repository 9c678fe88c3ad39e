"""PyTorch port vs the JAX package: the training slice, on the CPU.

- Optimizers: Adam (with and without weight decay), AdamW and SGD against the
  JAX package's optax chains over a few steps, and a ReduceLROnPlateau trace.
- One train step of a tiny flagship-architecture UNet (16 px, 16 channels,
  mult (1, 2), attention at ds 2 and in the mid block, dropout 0): weights
  carried across by ``unet_state_dict_from_flax``, the same batch and t; the
  loss and every parameter gradient (mapped through the same converter)
  against ``jax.value_and_grad``, then the Adam-updated parameters, at 3e-4.
- Data: the synthetic generator and the datamodule's batches against the JAX
  package's.
- The entry point on the CPU (``experiment=smoke_synthetic trainer=cpu``):
  the loss is finite and falls, checkpoints are written, resume is exact,
  test from a checkpoint reproduces the loss, and the trainer's knobs.
"""

from __future__ import annotations

import functools
import logging
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stain2stain_tpu.data import PairedDataModule as JaxPairedDataModule
from stain2stain_tpu.data.synthetic import generate_paired_dataset as j_generate_paired_dataset
from stain2stain_tpu.data.synthetic import make_tile_pair as j_make_tile_pair
from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.cfm import ConditionalFlowMatcher as JaxFlowMatcher
from stain2stain_tpu.ops.image import normalize_uint8 as j_normalize_uint8
from stain2stain_tpu.ops.losses import mse_loss as j_mse_loss
from stain2stain_tpu.training import optim as joptim
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.config import compose, instantiate
from stain2stain_tpu_torch.data import DataLoader
from stain2stain_tpu_torch.data import device_cache as tdevice_cache
from stain2stain_tpu_torch.data.paired_data_module import PairedDataset
from stain2stain_tpu_torch.data.synthetic import make_tile_pair
from stain2stain_tpu_torch.data.synthetic_module import SyntheticPairedDataModule
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.tasks import ConditionalFlowMatchingModule
from stain2stain_tpu_torch.train import train
from stain2stain_tpu_torch.training import Trainer
from stain2stain_tpu_torch.training import optim as toptim

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = REPO_ROOT / "configs"
TOL = 3e-4  # nets: f32 on both sides, summation order only (as tests/test_compat.py)
OPT_TOL = 1e-6

SIZE = 16
TINY = dict(num_channels=16, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8", num_head_channels=8)
CONV_KW = dict(image_size=SIZE, **TINY)


# ------------------------------------------------------------- optimizers


def _run_optax(tx, params, grads_seq):
    state = tx.init(params)
    for g in grads_seq:
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params


def _run_torch(make_opt, params, grads_seq):
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_opt(list(leaves.values()))
    for g in grads_seq:
        for k, p in leaves.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    return {k: p.detach().numpy() for k, p in leaves.items()}


def _params_and_grads(steps: int):
    rng = np.random.default_rng(30)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_step_matches_optax(weight_decay):
    """One Adam step (then two more), L2 decay into the gradient, against optax."""
    params, grads = _params_and_grads(3)
    for n in (1, 3):
        ref = _run_optax(joptim.Adam(lr=1e-3, weight_decay=weight_decay), params, grads[:n])
        got = _run_torch(lambda p: toptim.Adam(p, lr=1e-3, weight_decay=weight_decay), params, grads[:n])
        for k in params:
            np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=OPT_TOL, rtol=0)


@pytest.mark.parametrize(
    "name,jax_tx,make",
    [
        ("adamw", lambda: joptim.AdamW(lr=1e-3, weight_decay=0.05), lambda p: toptim.AdamW(p, lr=1e-3, weight_decay=0.05)),
        ("sgd", lambda: joptim.SGD(lr=1e-2, momentum=0.9, weight_decay=0.01),
         lambda p: toptim.SGD(p, lr=1e-2, momentum=0.9, weight_decay=0.01)),
    ],
)
def test_adamw_and_sgd_match_optax(name, jax_tx, make):
    params, grads = _params_and_grads(3)
    ref = _run_optax(jax_tx(), params, grads)
    got = _run_torch(make, params, grads)
    for k in params:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=OPT_TOL, rtol=0, err_msg=name)


def test_reduce_lr_on_plateau_trace_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.93, 0.92, 0.91, 0.95, 0.97, 0.89, 0.99, 1.0, 1.1, 0.5]
    kw = dict(mode="min", factor=0.5, patience=2, cooldown=1, min_lr=1e-5)
    j, t = joptim.ReduceLROnPlateau(**kw), toptim.ReduceLROnPlateau(**kw)
    trace_j = [j.step(m, 1e-3) for m in metrics]
    trace_t = [t.step(m, 1e-3) for m in metrics]
    assert trace_t == trace_j and any(x is not None for x in trace_t)
    assert t.state_dict() == j.state_dict()
    fresh = toptim.ReduceLROnPlateau(**kw)
    fresh.load_state_dict(json.loads(json.dumps(t.state_dict())))
    assert fresh.state_dict() == t.state_dict()


def test_learning_rate_get_and_set():
    opt = toptim.Adam([torch.zeros(2, requires_grad=True)], lr=2e-4, flatten=False)
    assert toptim.get_learning_rate(opt) == 2e-4
    toptim.set_learning_rate(opt, 5e-5)
    assert toptim.get_learning_rate(opt) == 5e-5 and opt.flatten is False


# ----------------------------------------------------------- the train step


def test_train_step_matches_jax_loss_gradients_and_adam_update():
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, dropout=0.0, **TINY)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,), jnp.float32), jnp.zeros((2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(31)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params["params"]
    )
    src_u8, tgt_u8 = (rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2))
    t = np.array([0.3, 0.75], np.float32)

    src, tgt = j_normalize_uint8(jnp.asarray(src_u8)), j_normalize_uint8(jnp.asarray(tgt_u8))

    def loss_fn(p):
        matcher = JaxFlowMatcher(sigma=0.0)
        xt = matcher.sample_xt(None, src, tgt, jnp.asarray(t))
        vt = jnet.apply({"params": p}, jnp.asarray(t), xt, train=True)
        return j_mse_loss(vt, matcher.conditional_flow(src, tgt, t))

    with jax.default_matmul_precision("highest"):
        ref_loss, ref_grads = jax.value_and_grad(loss_fn)(params)
        tx = joptim.Adam(lr=1e-4)
        updates, _ = tx.update(ref_grads, tx.init(params), params)
        ref_new = optax.apply_updates(params, updates)

    tnet = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dropout=0.0, **TINY)
    tnet.load_state_dict(unet_state_dict_from_flax(params, **CONV_KW), strict=True)
    task = ConditionalFlowMatchingModule(net=tnet, optimizer=functools.partial(toptim.Adam, lr=1e-4))
    optimizer, _ = task.configure_optimizers()
    prepared = task.prepare_batch((src_u8, tgt_u8), train=True)  # no augment: the batch as given
    loss, metrics = task.loss_and_metrics(prepared, train=True, t=torch.from_numpy(t))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=TOL, rtol=TOL)
    assert metrics["loss"].requires_grad is False

    ref_grad_sd = unet_state_dict_from_flax(jax.device_get(ref_grads), **CONV_KW)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grad_sd[name].numpy(), atol=TOL, rtol=TOL, err_msg=name)

    optimizer.step()
    ref_new_sd = unet_state_dict_from_flax(jax.device_get(ref_new), **CONV_KW)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_new_sd[name].numpy(), atol=TOL, rtol=TOL, err_msg=name)


def test_unet_dropout_in_training_mode_only():
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dropout=0.5, **TINY)
    with torch.no_grad():
        for p in net.parameters():  # ADM zero-inits the output convs, which would hide dropout
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(1)))
    x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0.2, 0.6])
    net.train()
    a = net(t, x, generator=torch.Generator().manual_seed(7))
    b = net(t, x, generator=torch.Generator().manual_seed(7))
    c = net(t, x, generator=torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    net.eval()
    with torch.no_grad():
        assert torch.equal(net(t, x, generator=torch.Generator().manual_seed(7)), net(t, x))


def test_bf16_mixed_keeps_f32_parameters_and_grads():
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dtype="bfloat16", **TINY)
    task = ConditionalFlowMatchingModule(net=net)
    batch = tuple(np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8) for _ in range(2))
    loss, _ = task.loss_and_metrics(task.prepare_batch(batch), torch.Generator().manual_seed(0), train=True)
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in net.parameters())


# --------------------------------------------------------------------- data


def test_synthetic_tiles_match_jax():
    for deterministic in (False, True):
        a = make_tile_pair(np.random.default_rng(5), 24, deterministic=deterministic)
        b = j_make_tile_pair(np.random.default_rng(5), 24, deterministic=deterministic)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_datamodule_batches_match_jax(tmp_path):
    """The port's synthetic module writes the JAX package's tree (same names,
    same pixels) and yields the same epoch-shuffled batches."""
    dm = SyntheticPairedDataModule(data_dir=str(tmp_path), n_train=6, n_val=3, n_test=2, tile_size=24,
                                   image_size=16, batch_size=2, num_workers=2)
    dm.setup("fit")
    j_root = j_generate_paired_dataset(tmp_path / "jax", n_train=6, n_val=3, n_test=2, size=24, seed=0)
    jdm = JaxPairedDataModule(data_dir=str(j_root), batch_size=2, num_workers=2, image_size=16,
                              use_augmentation=True, load_size=24, direction="S2T")
    jdm.setup("fit")
    assert dm.train_augment == jdm.train_augment
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader())):
        for epoch in (0, 1):
            port_loader.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            got, ref = list(port_loader), list(jax_loader)
            assert len(got) == len(ref) == len(port_loader)
            for g, r in zip(got, ref):
                for x, y in zip(g, r):
                    np.testing.assert_array_equal(x, y)


def test_native_batch_decode_matches_per_tile_decode(tmp_path):
    dm = SyntheticPairedDataModule(data_dir=str(tmp_path), n_train=4, n_val=2, n_test=2, tile_size=24, image_size=16)
    dm.setup("fit")
    ds: PairedDataset = dm._inner.datasets["val"]  # resized 24 → 16 on the host
    per_tile = [ds[i] for i in range(len(ds))]
    batch = ds.get_batch(np.arange(len(ds)))
    if batch is None:
        pytest.skip("the native decoder library is not built here")
    for field in range(2):
        want = np.stack([s[field] for s in per_tile]).astype(np.int16)
        # the native bilinear resize rounds in fixed point, cv2's differently:
        # at most one grey level apart (as tests/test_data.py holds the JAX package)
        assert np.abs(batch[field].astype(np.int16) - want).max() <= 1


def test_device_cache_yields_the_streaming_batches(tmp_path, monkeypatch):
    """The device cache gathers the streaming loader's batches (its device
    resolved to the CPU here; on the card it is the CUDA device)."""
    monkeypatch.setattr(tdevice_cache, "resolve_device", lambda device=None: torch.device("cpu"))
    dm = SyntheticPairedDataModule(data_dir=str(tmp_path), n_train=6, n_val=2, n_test=2, tile_size=24,
                                   image_size=16, batch_size=2)
    dm.setup("fit")
    ds = dm._inner.datasets["train"]
    cached = tdevice_cache.DeviceCacheLoader(ds, batch_size=2, shuffle=True, drop_last=True, seed=3)
    streamed = DataLoader(ds, batch_size=2, shuffle=True, drop_last=True, seed=3)
    for epoch in (0, 1):
        cached.set_epoch(epoch)
        streamed.set_epoch(epoch)
        for c, s in zip(cached, streamed):
            assert torch.is_tensor(c[0]) and c[0].dtype == torch.uint8
            np.testing.assert_array_equal(c[0].numpy(), s[0])
            np.testing.assert_array_equal(c[1].numpy(), s[1])
    with pytest.raises(ValueError, match="cache must be"):
        tdevice_cache.resolve_loader_class("host")


# -------------------------------------------------------------- entry point


def make_cfg(tmp_path: Path, extra=(), out: str = "out"):
    overrides = ["experiment=smoke_synthetic", "trainer=cpu", f"data.data_dir={tmp_path}/synthetic",
                 "logger=csv", *extra]
    cfg = compose(CONFIG_DIR, "train.yaml", overrides)
    (tmp_path / out).mkdir(exist_ok=True)
    cfg["runtime"] = {"output_dir": str(tmp_path / out), "cwd": str(tmp_path)}
    cfg["extras"]["print_config"] = False
    cfg["extras"]["enforce_tags"] = False
    return cfg


def _csv_rows(out_dir: Path) -> list[dict]:
    import csv

    (path,) = list(out_dir.rglob("metrics.csv"))
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """One CPU run of the smoke experiment: 3 epochs, test on the best checkpoint."""
    tmp = tmp_path_factory.mktemp("smoke")
    cfg = make_cfg(tmp, ["trainer.max_epochs=3", "test=true", "model.optimizer.lr=1e-3"])
    metrics, objects = train(cfg)
    return tmp, cfg, metrics, objects


def test_train_cli_loss_is_finite_and_falls(smoke_run):
    tmp, _, metrics, objects = smoke_run
    rows = _csv_rows(tmp / "out")
    train_losses = [float(r["train/loss"]) for r in rows if r.get("train/loss")]
    val_losses = [float(r["val/loss"]) for r in rows if r.get("val/loss")]
    assert len(val_losses) == 3 and len(train_losses) >= 6
    assert all(np.isfinite(train_losses)) and all(np.isfinite(val_losses))
    assert val_losses[-1] < val_losses[0]
    assert objects["trainer"].global_step == 6  # 8 tiles / batch 4 × 3 epochs
    assert {"train/loss", "val/loss", "test/loss"} <= set(metrics)


def test_train_cli_writes_last_and_best_checkpoints(smoke_run):
    _, _, _, objects = smoke_run
    ckpt = objects["trainer"].checkpoint_callback
    for path in (ckpt.best_model_path, ckpt.last_model_path):
        assert (Path(path) / "state.pt").is_file() and (Path(path) / "meta.json").is_file()
    assert Path(ckpt.best_model_path).name.startswith("best-")
    meta = json.loads((Path(ckpt.last_model_path) / "meta.json").read_text())
    # the JAX package's meta keys (training/state.py, trainer.py save_checkpoint)
    assert set(meta) == {"epoch", "global_step", "callback_metrics", "scheduler", "base_lr", "callbacks", "rng"}
    assert meta["epoch"] == 2 and meta["global_step"] == 6
    assert set(meta["callbacks"]) >= {"ModelCheckpoint", "EarlyStopping"}


def test_test_from_checkpoint_reproduces_the_loss_exactly(smoke_run):
    _, cfg, metrics, objects = smoke_run
    best = objects["trainer"].checkpoint_callback.best_model_path
    net = instantiate(cfg.model.net, device="cpu")  # fresh random weights, replaced from the checkpoint
    task = instantiate(cfg.model, net=net)
    again = Trainer(accelerator="cpu", logger=False).test(task, objects["datamodule"], ckpt_path=best)
    assert again["test/loss"] == metrics["test/loss"]


def test_train_cli_resume_is_exact(tmp_path):
    """1 epoch, then resume from `last` to 2 epochs: the run continues at the
    saved epoch and ends with the weights and optimizer state of an
    uninterrupted 2-epoch run."""
    _, full = train(make_cfg(tmp_path, ["trainer.max_epochs=2", "test=false"], out="full"))
    _, first = train(make_cfg(tmp_path, ["trainer.max_epochs=1", "test=false"], out="first"))
    last = first["trainer"].checkpoint_callback.last_model_path
    cfg = make_cfg(tmp_path, ["trainer.max_epochs=2", "test=false"], out="resumed")
    cfg["ckpt_path"] = last
    _, resumed = train(cfg)
    assert resumed["trainer"].current_epoch == 1
    assert resumed["trainer"].global_step == full["trainer"].global_step == 4
    ref, got = full["model"].net.state_dict(), resumed["model"].net.state_dict()
    assert all(torch.equal(ref[k], got[k]) for k in ref)
    ref_opt = full["trainer"].state.optimizer.state_dict()["state"]
    got_opt = resumed["trainer"].state.optimizer.state_dict()["state"]
    for i in ref_opt:
        assert all(torch.equal(ref_opt[i][k], got_opt[i][k]) for k in ref_opt[i])


@pytest.mark.parametrize(
    "extra,check",
    [
        (["trainer.fast_dev_run=true", "test=false"], lambda o, m: o["trainer"].global_step == 1),
        (["trainer.max_epochs=1", "test=false", "+trainer.accumulate_grad_batches=2"],
         lambda o, m: o["trainer"].global_step == 2 and 0.0 < m["train/loss"] < 10.0),
        (["trainer.max_epochs=1", "test=false", "+trainer.gradient_clip_val=0.01"],
         lambda o, m: o["trainer"].global_step == 2 and np.isfinite(m["train/loss"])),
        (["trainer.max_epochs=2", "test=false", "trainer.precision=bf16-mixed"],
         lambda o, m: o["model"].net.dtype == torch.bfloat16 and np.isfinite(m["val/loss"])),
        (["trainer.max_epochs=3", "test=false", "+trainer.max_steps=3"], lambda o, m: o["trainer"].global_step == 3),
        (["trainer.max_epochs=3", "test=false", "+trainer.overfit_batches=1"],
         lambda o, m: o["trainer"].global_step == 3),
        # no val/loss can beat the best by 10: stop after the second validation
        (["trainer.max_epochs=5", "test=false", "callbacks.early_stopping.patience=1",
          "callbacks.early_stopping.min_delta=10.0"], lambda o, m: o["trainer"].global_step == 4),
        # in "max" mode a falling val/loss never improves: the lr halves after epoch 2
        (["trainer.max_epochs=2", "test=false", "model.scheduler.mode=max", "model.scheduler.patience=0",
          "model.scheduler.factor=0.5"], lambda o, m: o["trainer"].current_lr == 5e-5),
    ],
    ids=["fast_dev_run", "accumulate_grad_batches", "gradient_clip_val", "bf16_mixed", "max_steps",
         "overfit_batches", "early_stopping", "reduce_lr_on_plateau"],
)
def test_trainer_knobs(tmp_path, extra, check):
    metrics, objects = train(make_cfg(tmp_path, extra))
    assert check(objects, metrics)


def test_val_check_interval_validates_mid_epoch(tmp_path):
    train(make_cfg(tmp_path, ["trainer.max_epochs=1", "test=false", "+trainer.val_check_interval=1"]))
    rows = _csv_rows(tmp_path / "out")
    assert len([r for r in rows if r.get("val/loss")]) == 2  # after batch 1, and at the epoch end


@pytest.mark.parametrize(
    "override,err,match",
    [
        ("trainer=tpu", ValueError, r"trainer\.accelerator='tpu'"),
        ("trainer.accelerator=mps", ValueError, r"trainer\.accelerator='mps'"),
        # no process group: more devices than one warn and train on one, and an
        # fsdp that does not divide the world runs as fsdp=1 (JAX trainer.py:244-251);
        # the ids are those of the cases' first form, when the port refused both
        pytest.param("trainer.devices=2", None, "Requested 2 devices", id="trainer.devices=2-ValueError-one device"),
        pytest.param("+trainer.fsdp=2", None, "fsdp=2 does not divide", id="+trainer.fsdp=2-ValueError-one device"),
        ("trainer.accelerator=gpu", RuntimeError, "no CUDA device"),
    ],
)
def test_trainer_refuses_what_the_port_does_not_run(tmp_path, override, err, match, monkeypatch, caplog):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = compose(CONFIG_DIR, "train.yaml", ["experiment=smoke_synthetic", "trainer=cpu", override])
    cfg["runtime"] = {"output_dir": str(tmp_path), "cwd": str(tmp_path)}
    if err is None:
        with caplog.at_level(logging.WARNING):
            trainer = instantiate(cfg.trainer)
        assert match in caplog.text
        assert (trainer.world_size, trainer.fsdp, trainer.device.type) == (1, 1, "cpu")
        return
    with pytest.raises(err, match=match):
        instantiate(cfg.trainer)


def test_train_cli_runs_as_a_module(tmp_path):
    """``python -m stain2stain_tpu_torch.train`` composes, trains and checkpoints."""
    cmd = [sys.executable, "-m", "stain2stain_tpu_torch.train", "experiment=smoke_synthetic", "trainer=cpu",
           "trainer.max_epochs=1", "test=true", "extras.print_config=false"]
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), PROJECT_ROOT=str(tmp_path))
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert list((tmp_path / "logs" / "train").rglob("last/state.pt"))
    assert "Best ckpt path" in out.stderr


def test_loggers_write_their_files(tmp_path):
    from stain2stain_tpu_torch.training import CSVLogger, FileLogger

    csv_logger = CSVLogger(save_dir=str(tmp_path), name="csv")
    csv_logger.log_hyperparams({"lr": 1e-4})
    csv_logger.log_metrics({"train/loss": torch.tensor(0.5)}, step=1)
    csv_logger.log_metrics({"val/loss": 0.25}, step=2)
    csv_logger.finalize()
    rows = _csv_rows(tmp_path / "csv")
    assert [r["step"] for r in rows] == ["1", "2"] and rows[1]["val/loss"] == "0.25"
    assert json.loads((tmp_path / "csv" / "version_0" / "hparams.json").read_text()) == {"lr": 1e-4}
    assert CSVLogger(save_dir=str(tmp_path), name="csv").log_dir.name == "version_1"

    file_logger = FileLogger(save_dir=str(tmp_path), name="file")
    file_logger.log_metrics({"loss": 1.5}, step=3)
    file_logger.log_model("ckpt/last", {"epoch": 0})
    file_logger.log_images("val", {"source": np.full((2, 4, 4, 3), 0.5, np.float32)}, step=3)
    file_logger.finalize()
    lines = [json.loads(x) for x in (tmp_path / "file" / "metrics.jsonl").read_text().splitlines()]
    assert lines[0] == {"step": 3, "loss": 1.5} and lines[1]["model_artifact"] == "ckpt/last"
    assert len(list((tmp_path / "file" / "images" / "step_3").glob("val_source_*.png"))) == 2

"""The flagship quality recipe of the port, on the CPU at a tiny size.

- ``scripts/torch_gen_quality_tiles.py`` writes the JAX package's tree byte
  for byte (every PNG and the CSV, by sha256).
- ``experiment=quality_real_256`` and ``quality_synthetic_256`` compose
  through the port's ``config/`` with ``trainer.accelerator=cpu`` and
  instantiate the port's classes; without it they are refused by name
  (their ``trainer: tpu``).
- On one tiny tree at a tiny width the two experiments take the same first
  train step, bit for bit.
- ``scripts/torch_quality_run.py`` (``--device cpu``): two one-epoch
  segments end with the weights and Adam moments of one two-epoch run, bit
  for bit, and its summary line carries every key of the recipe's report.
- The port's UNet starts from the JAX package's initialization: per
  tensor, the same zeros and the same spread (lecun-normal kernels, zero
  biases), where torch's own defaults drew a third of the variance and
  nonzero biases (the departure the quality control found).
- Neither script imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stain2stain_tpu.data.synthetic import generate_paired_dataset as j_generate_paired_dataset
from stain2stain_tpu_torch.config import compose, instantiate
from stain2stain_tpu_torch.train import train
from stain2stain_tpu_torch.utils.utils import instantiate_callbacks

REPO_ROOT = Path(__file__).resolve().parent.parent
CONFIG_DIR = REPO_ROOT / "configs"
SCRIPTS = REPO_ROOT / "scripts"
TREE = dict(n_train=4, n_val=2, n_test=2, size=32)
# a tiny flagship-architecture net (attention at 16 px) on 32-px tiles, streamed (the device cache is the card's),
# in f32 (bf16 convs are slow on the CPU; these tests are about the data path and resume)
TINY_NET = ["model.net.dim=[3,32,32]", "model.net.num_channels=16", "model.net.num_res_blocks=1",
            "model.net.channel_mult=[1,2]", "model.net.attention_resolutions='16'", "model.net.num_heads=1",
            "model.net.num_head_channels=8", "data.batch_size=2", "data.cache=null", "data.num_workers=1",
            "trainer.precision=32"]
TINY_REAL = TINY_NET + ["data.image_size=32", "data.load_size=32"]
TINY_SYNTHETIC = TINY_NET + ["data.tile_size=32", "data.image_size=32", "data.n_train=4", "data.n_val=2",
                             "data.n_test=2"]


@pytest.fixture(autouse=True)
def _one_host_thread():
    """Run the tiny nets at one host thread: in a parallel test run, torch's
    and BLAS's thread pools would oversubscribe the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        limits = contextlib.nullcontext()
    else:
        limits = threadpool_limits(1)
    try:
        with limits:
            yield
    finally:
        torch.set_num_threads(threads)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_tile_script_writes_the_jax_tree_byte_for_byte(tmp_path):
    _script("torch_gen_quality_tiles").main([str(tmp_path / "port"), "--n-train", "4", "--n-val", "2",
                                             "--n-test", "2", "--size", "32"])
    j_generate_paired_dataset(tmp_path / "jax", seed=0, deterministic=True, **TREE)
    port, jax_tree = _digests(tmp_path / "port"), _digests(tmp_path / "jax")
    assert len(port) == 2 * 8 + 1 and "metadata.csv" in port
    assert port == jax_tree


@pytest.mark.parametrize("experiment,datamodule", [("quality_real_256", "PairedDataModule"),
                                                   ("quality_synthetic_256", "SyntheticPairedDataModule")])
def test_quality_experiments_compose_on_the_port(experiment, datamodule, tmp_path):
    from stain2stain_tpu_torch.training import ModelCheckpoint

    cfg = compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}", "trainer.accelerator=cpu"])
    cfg["runtime"] = {"output_dir": str(tmp_path), "cwd": str(tmp_path)}
    dm = instantiate(cfg.data)
    assert type(dm).__module__.startswith("stain2stain_tpu_torch.") and type(dm).__name__ == datamodule
    assert cfg.data.cache == "device" and cfg.data.batch_size == 32 and cfg.seed == 0 and cfg.test
    callbacks = instantiate_callbacks(cfg.callbacks)
    ckpt = next(cb for cb in callbacks if isinstance(cb, ModelCheckpoint))
    assert ckpt.save_on_train_epoch_end is False and ckpt.save_last and ckpt.monitor == "val/loss"
    trainer = instantiate(cfg.trainer, callbacks=callbacks, logger=None)
    assert type(trainer).__module__ == "stain2stain_tpu_torch.training.trainer"
    assert trainer.device.type == "cpu" and trainer.precision == "bf16-mixed"
    assert trainer.check_val_every_n_epoch == 20
    assert cfg.model["_target_"].endswith("ConditionalFlowMatchingModule") and cfg.model.net.num_channels == 128

    refused = compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}"])
    refused["runtime"] = cfg["runtime"]
    assert refused.trainer.accelerator == "tpu"
    with pytest.raises(ValueError, match="'tpu' is not supported by the port"):
        instantiate(refused.trainer)


def _first_loss(experiment: str, overrides: list, work: Path) -> float:
    cfg = compose(CONFIG_DIR, "train.yaml", [f"experiment={experiment}", "trainer.accelerator=cpu",
                                             "trainer.max_epochs=1", "trainer.limit_train_batches=1",
                                             "trainer.check_val_every_n_epoch=1", "trainer.limit_val_batches=1",
                                             "test=false", *overrides])
    cfg["runtime"] = {"output_dir": str(work), "cwd": str(work)}
    metrics, objects = train(cfg)
    assert type(objects["datamodule"]).__name__ == ("SyntheticPairedDataModule" if "synthetic" in experiment
                                                    else "PairedDataModule")
    assert objects["trainer"].global_step == 1
    return metrics["train/loss"]


def test_both_quality_experiments_take_the_same_first_step(tmp_path):
    # the synthetic module writes its tree under data_dir/<variant>; the real one reads that tree
    tree = tmp_path / "data" / "s32_m0_n4-2-2_seed0_det"
    _script("torch_gen_quality_tiles").main([str(tree), "--n-train", "4", "--n-val", "2", "--n-test", "2",
                                             "--size", "32"])
    real = _first_loss("quality_real_256", TINY_REAL + [f"data.data_dir={tree}"], tmp_path / "real")
    synthetic = _first_loss("quality_synthetic_256", TINY_SYNTHETIC + [f"data.data_dir={tmp_path / 'data'}"],
                            tmp_path / "synthetic")
    assert real == synthetic


def _state(work: Path) -> dict:
    return torch.load(work / "run" / "checkpoints" / "last" / "state.pt", weights_only=True)


def _assert_equal(a, b, where: str = "") -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_quality_run_resumes_in_segments_bit_for_bit(tmp_path, capsys):
    run = _script("torch_quality_run")
    tiles = tmp_path / "tiles"
    _script("torch_gen_quality_tiles").main([str(tiles), "--n-train", "4", "--n-val", "2", "--n-test", "2",
                                             "--size", "32"])
    common = ["--path", "unfused", "--device", "cpu", "--tiles", str(tiles), "--max-epochs", "2",
              *(f"--set={o}" for o in TINY_REAL + ["trainer.check_val_every_n_epoch=1"])]
    first = run.main(common + ["--work", str(tmp_path / "segments"), "--until-epoch", "1"])
    assert first["epochs"] == 1 and first["ssim"] == {}
    whole = run.main(common + ["--work", str(tmp_path / "whole")])
    resumed = run.main(common + ["--work", str(tmp_path / "segments")])
    a, b = _state(tmp_path / "segments"), _state(tmp_path / "whole")
    assert a["step"] == b["step"] == 4
    _assert_equal(a["model"], b["model"], "model")
    _assert_equal(a["optimizer"], b["optimizer"], "optimizer")
    assert resumed["val_loss"] == whole["val_loss"] and resumed["test_loss"] == whole["test_loss"]
    assert resumed["ssim"] == whole["ssim"] and resumed["psnr"] == whole["psnr"]

    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    kinds = [ln["kind"] for ln in lines]
    assert kinds == (["segment", "summary"] + ["segment"] + ["eval"] * 4 + ["summary"]
                     + ["segment"] + ["eval"] * 4 + ["summary"])
    summary = lines[-1]
    for key in ("card", "val_loss", "step_ms_median", "peak_gib", "wall_s", "train_launches", "eval_launches",
                "test_loss", "ssim", "psnr", "fid", "fid_comparable", "jax_record", "bands", "bands_met"):
        assert key in summary, key
    assert [e for e, _ in summary["val_loss"]] == [1, 2] and summary["fid_comparable"] is False
    assert set(summary["ssim"]) == {"euler-2", "euler-8", "euler-50", "dopri5"}
    assert all(-1 <= v <= 1 for v in summary["ssim"].values())
    assert set(summary["train_launches"]) == {"K1-fwd", "K1-bwd", "K2", "K3", "K4", "K5", "dropout",
                                            "ln_modulate_fwd", "ln_modulate_bwd"}
    assert summary["jax_record"]["quality_real_256"]["ssim"]["euler-2"] == 0.935


def test_quality_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _script("torch_quality_run").main(["--path", "unfused", "--work", str(tmp_path), "--tiles",
                                           str(tmp_path / "tiles")])
    assert not (tmp_path / "tiles").exists()


@pytest.mark.parametrize("class_cond", [False, True], ids=["plain", "class_cond"])
def test_unet_initialization_matches_jax(class_cond):
    import jax
    import jax.numpy as jnp

    from stain2stain_tpu.models import UNetModel as JaxUNet
    from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
    from stain2stain_tpu_torch.models import UNetModel

    kw = dict(num_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8",
              num_head_channels=8, class_cond=class_cond, num_classes=3 if class_cond else None)
    x = jnp.zeros((1, 16, 16, 3), jnp.float32)
    y = jnp.zeros((1,), jnp.int32) if class_cond else None
    jnet = JaxUNet(dim=(3, 16, 16), fused_attention=False, dtype=jnp.float32, **kw)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((1,), jnp.float32), x, y)["params"]
    want = unet_state_dict_from_flax(jax.device_get(params), image_size=16, **{
        k: kw[k] for k in ("num_channels", "num_res_blocks", "channel_mult", "attention_resolutions",
                           "num_head_channels", "class_cond")})
    torch.manual_seed(0)
    got = UNetModel(dim=(3, 16, 16), device="cpu", **kw).state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if not torch.any(w != 0):
            assert not torch.any(g != 0), f"{key}: zero in JAX, not in the port"
            continue
        assert torch.any(g != 0), f"{key}: zero in the port, not in JAX"
        if key.endswith("label_emb.weight"):  # flax's Embed: normal, variance 1/features
            scale = w.shape[1] ** -0.5
        elif "norm" in key or key.endswith(".0.weight") and w.ndim == 1:  # GroupNorm scales: ones in both
            assert torch.equal(g, w), key
            continue
        else:  # lecun-normal: variance 1/fan_in, truncated at two deviations of the underlying normal
            scale = w[0].numel() ** -0.5
            bound = 2 * scale / 0.87962566103423978
            assert g.abs().max() <= bound * (1 + 1e-6) and w.abs().max() <= bound * (1 + 1e-6), key
        if w.numel() >= 512:
            for t in (g, w):
                assert 0.85 < float(t.std()) / scale < 1.15, (key, float(t.std()), scale)


def test_quality_scripts_import_nothing_of_jax():
    code = (
        "import importlib.util, sys\n"
        f"for name in ('torch_gen_quality_tiles', 'torch_quality_run'):\n"
        f"    spec = importlib.util.spec_from_file_location(name, {str(SCRIPTS)!r} + '/' + name + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import stain2stain_tpu_torch.quality\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', 'stain2stain_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'optax.', 'stain2stain_tpu.')))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""The port's MNIST template demo against the JAX package's, on the CPU.

- The synthetic digits and the 55k/5k/10k split scaled to them, bit for bit
  (numpy on both sides), and the first batches of each loader.
- ``SimpleDenseNet`` logits through ``simple_dense_net_state_dict_from_flax``
  within 1e-5 (f32, ``jax.default_matmul_precision("highest")``); bf16
  compute gives f32 logits.
- ``MNISTLitModule``'s normalization, loss and accuracy within 1e-5.
- ``experiment=example trainer=cpu`` with limited batches logs
  ``val/acc_best``, the running max of ``val/acc``.
"""

from __future__ import annotations

import csv
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.data.mnist_datamodule import MNISTDataModule as JaxMNISTDataModule
from stain2stain_tpu.data.mnist_datamodule import _synthetic_mnist as j_synthetic_mnist
from stain2stain_tpu.models.simple_dense_net import SimpleDenseNet as JaxSimpleDenseNet
from stain2stain_tpu.tasks import MNISTLitModule as JaxMNISTLitModule
from stain2stain_tpu_torch.compat import simple_dense_net_state_dict_from_flax
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.data import MNISTDataModule
from stain2stain_tpu_torch.data.mnist_datamodule import _synthetic_mnist
from stain2stain_tpu_torch.models import SimpleDenseNet
from stain2stain_tpu_torch.tasks import MNISTLitModule
from stain2stain_tpu_torch.train import train

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5  # a 4-layer MLP, f32 on both sides: summation order only
WIDTHS = dict(lin1_size=32, lin2_size=48, lin3_size=16)


@pytest.mark.parametrize("n,seed", [(64, 0), (500, 12345)])
def test_synthetic_mnist_matches_jax(n, seed):
    images, labels = _synthetic_mnist(n, seed)
    ref_images, ref_labels = j_synthetic_mnist(n, seed)
    assert images.dtype == np.uint8 and images.shape == (n, 28, 28)
    np.testing.assert_array_equal(images, ref_images)
    np.testing.assert_array_equal(labels, ref_labels)


def test_split_and_batches_match_jax(tmp_path):
    dm = MNISTDataModule(data_dir=str(tmp_path), batch_size=32, synthetic_size=700, seed=3)
    jdm = JaxMNISTDataModule(data_dir=str(tmp_path), batch_size=32, synthetic_size=700, seed=3)
    for m in (dm, jdm):
        m.prepare_data()
        m.setup("fit")
    assert (dm.num_shards, dm.shard_index) == (1, 0)
    for split in ("data_train", "data_val", "data_test"):
        ours, ref = getattr(dm, split), getattr(jdm, split)
        np.testing.assert_array_equal(ours.images, ref.images)
        np.testing.assert_array_equal(ours.labels, ref.labels)
    assert [len(getattr(dm, s)) for s in ("data_train", "data_val", "data_test")] == [550, 50, 100]
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        got, want = getattr(dm, loader)(), getattr(jdm, loader)()
        assert len(got) == len(want)
        for a, b in zip(next(iter(got)), next(iter(want))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _nets(seed: int = 0):
    jnet = JaxSimpleDenseNet(**WIDTHS)
    variables = jnet.init(jax.random.key(seed), jnp.zeros((2, 28, 28, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # flax zero-inits the biases and ones-inits the norms: perturb them so every tensor is checked
    rng = np.random.default_rng(seed)
    params = {k: {n: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32) for n, v in p.items()}
              for k, p in params.items()}
    net = SimpleDenseNet(**WIDTHS, device="cpu")
    net.load_state_dict(simple_dense_net_state_dict_from_flax(params))
    return jnet, {"params": params}, net


def test_simple_dense_net_logits_match_jax():
    jnet, variables, net = _nets()
    assert set(net.state_dict()) == {f"{m}_{i}.{p}" for m in ("dense", "norm") for i in range(3)
                                     for p in ("weight", "bias")} | {"head.weight", "head.bias"}
    assert net.norm_0.eps == 1e-6
    x = np.random.default_rng(1).standard_normal((5, 28, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (5, 10)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL, rtol=TOL)
    net.dtype = torch.bfloat16  # bf16 compute: the norms in f32, the logits f32
    low = net(torch.from_numpy(x))
    assert low.dtype == torch.float32 and np.abs(low.detach().numpy() - ref).max() < 0.1 * np.abs(ref).max()


def test_task_loss_and_accuracy_match_jax():
    jnet, variables, net = _nets(2)
    images, labels = _synthetic_mnist(16, 4)
    labels = labels.astype(np.int32)  # the collate's dtype
    jtask = JaxMNISTLitModule(net=jnet)
    task = MNISTLitModule(net=net, device="cpu")
    prepared = task.prepare_batch((images, labels), train=True)
    jprepared = jtask.prepare_batch((jnp.asarray(images), jnp.asarray(labels)), jax.random.key(0), train=True)
    assert prepared[0].dtype == torch.float32 and prepared[1].dtype == torch.int64
    np.testing.assert_allclose(prepared[0].numpy(), np.asarray(jprepared[0])[..., 0], atol=TOL, rtol=0)
    with jax.default_matmul_precision("highest"):
        jloss, jmetrics, _ = jtask.loss_and_metrics(variables, jprepared, jax.random.key(0), train=True)
    loss, metrics = task.loss_and_metrics(prepared, train=True)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=TOL, rtol=TOL)
    assert metrics["acc"].item() == pytest.approx(float(jmetrics["acc"]), abs=TOL)
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in net.parameters())


def test_example_experiment_logs_the_running_best_accuracy(tmp_path):
    cfg = compose(REPO_ROOT / "configs", "train.yaml", [
        "experiment=example", "trainer=cpu", "logger=csv", "trainer.min_epochs=1", "trainer.max_epochs=3",
        "trainer.limit_train_batches=2", "trainer.limit_val_batches=2", "data.batch_size=32",
        "model.optimizer.lr=0.0005", f"data.data_dir={tmp_path}"])
    cfg["runtime"] = {"output_dir": str(tmp_path / "out"), "cwd": str(tmp_path)}
    cfg["extras"]["print_config"] = False
    metrics, objects = train(cfg)
    assert isinstance(objects["model"], MNISTLitModule) and objects["trainer"].global_step == 6
    (path,) = (tmp_path / "out").rglob("metrics.csv")
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    acc = [float(r["val/acc"]) for r in rows if r.get("val/acc")]
    best = [float(r["val/acc_best"]) for r in rows if r.get("val/acc_best")]
    assert len(acc) == 3 and best == list(np.maximum.accumulate(acc))
    assert metrics["val/acc_best"] == max(acc) and np.isfinite(metrics["val/loss"])

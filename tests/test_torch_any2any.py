"""The port's class-conditional (any↔any) slice against the JAX package, on
the CPU.

- Data: ``generate_domain_folders`` writes the JAX package's pixels, and the
  datamodule gives the JAX datamodule's batches bit for bit (same folders,
  same ``train_val_split.json``, epochs 0 and 1).
- Task: a tiny class-conditional UNet (16 px, 16 channels, attention at one
  level and in the mid block) with converted jittered weights: the loss
  under the target label with injected t and noise, ``generate`` for one
  class and for a class per example, ``generate_all_classes`` and the
  conditioned tiled generator, each within 3e-4 of JAX.
- Serving: the class-conditioned ``TranslationServer`` over HTTP honours
  ``?target_class=``, uses its default class, refuses a class out of range.
- Entry points: ``experiment=smoke_any2any trainer=cpu`` trains through
  ``train``; ``infer_any2any`` writes one panel with every class.
"""

from __future__ import annotations

import io
import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stain2stain_tpu.data import ClassConditionalAnyToAnyDataModule as JaxAny2AnyDataModule
from stain2stain_tpu.data.synthetic import generate_domain_folders as j_generate_domain_folders
from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.cfm import ConditionalFlowMatcher as JaxFlowMatcher
from stain2stain_tpu.ops.losses import mse_loss as j_mse_loss
from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
from stain2stain_tpu.tasks import ClassConditionalFlowMatchingModule as JaxClassCFM
from stain2stain_tpu.wsi import make_conditioned_tiled_generator as j_make_conditioned_tiled_generator
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.data import ClassConditionalAnyToAnyDataModule
from stain2stain_tpu_torch.data.synthetic import generate_domain_folders
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.ops.cfm import ConditionalFlowMatcher
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.server import TranslationServer, serve_forever
from stain2stain_tpu_torch.tasks import ClassConditionalFlowMatchingModule
from stain2stain_tpu_torch.train import train
from stain2stain_tpu_torch.wsi import make_conditioned_tiled_generator

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-4
SIZE = 16
TINY = dict(num_channels=16, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="8", num_head_channels=8,
            class_cond=True, num_classes=3)
MAPPING = {0: "HE", 1: "IHC", 2: "Grayscale"}


# --------------------------------------------------------------------- data


def test_domain_folders_and_batches_match_jax(tmp_path):
    root = generate_domain_folders(tmp_path / "port", n_images=10, size=40, seed=3)
    j_root = j_generate_domain_folders(tmp_path / "jax", n_images=10, size=40, seed=3)
    for dom in MAPPING.values():
        names = sorted(p.name for p in (root / dom).iterdir())
        assert names == sorted(p.name for p in (j_root / dom).iterdir()) and len(names) == 10
        for name in names:
            np.testing.assert_array_equal(np.asarray(Image.open(root / dom / name)),
                                          np.asarray(Image.open(j_root / dom / name)))
    kw = dict(data_dir=str(root), class_folder_mapping=MAPPING, crop_size=24, batch_size=3, num_workers=2,
              val_split=0.3, split_seed=7, seed=11)
    jdm = JaxAny2AnyDataModule(**kw)
    jdm.prepare_data()  # the JAX package writes the split file; the port reads it
    dm = ClassConditionalAnyToAnyDataModule(**kw)
    dm.prepare_data()
    assert json.loads(dm.split_file.read_text())["val_files"] == 3
    for m in (dm, jdm):
        m.setup("fit")
    assert dm.num_classes == jdm.num_classes == 3 and dm.field_kinds == jdm.field_kinds
    assert dm.train_augment is None and jdm.train_augment is None
    for port_loader, jax_loader in ((dm.train_dataloader(), jdm.train_dataloader()),
                                    (dm.val_dataloader(), jdm.val_dataloader()),
                                    (dm.test_dataloader(), jdm.test_dataloader())):
        for epoch in (0, 1):
            port_loader.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            got, ref = list(port_loader), list(jax_loader)
            assert len(got) == len(ref) > 0
            for g, r in zip(got, ref):
                for x, y in zip(g, r):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
    # the epoch moves the domain draws
    loader = dm.train_dataloader()
    labels = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        labels.append(np.concatenate([b[2] for b in loader]))
    assert labels[0].dtype == np.int32 and not np.array_equal(*labels)


def test_datamodule_refuses_bad_layouts(tmp_path):
    generate_domain_folders(tmp_path, domains=("HE", "IHC"), n_images=2, size=16)
    dm = ClassConditionalAnyToAnyDataModule(data_dir=str(tmp_path), class_folder_mapping=MAPPING)
    dm.prepare_data()
    with pytest.raises(ValueError, match="Folder not found"):
        dm.setup("fit")
    with pytest.raises(RuntimeError, match="Split file not found"):
        ClassConditionalAnyToAnyDataModule(data_dir=str(tmp_path / "none")).setup("fit")


# --------------------------------------------------------------------- task


@pytest.fixture(scope="module")
def tasks():
    """(JAX task, its variables, port task) with the same jittered weights."""
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, dropout=0.0, **TINY)
    x = jnp.zeros((2, SIZE, SIZE, 3))
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,)), x, jnp.zeros((2,), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    conv_kw = {k: v for k, v in TINY.items() if k != "num_classes"}
    tnet = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dropout=0.0, **TINY)
    tnet.load_state_dict(unet_state_dict_from_flax(params, image_size=SIZE, **conv_kw), strict=True)
    jtask = JaxClassCFM(net=jnet, solver=JaxSolverConfig("euler"), num_classes=3)
    ttask = ClassConditionalFlowMatchingModule(net=tnet, solver=SolverConfig("euler"), num_classes=3)
    return jtask, {"params": params}, ttask


def _source(batch: int = 2, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)


def test_loss_under_the_target_label_matches_jax(tasks):
    jtask, variables, ttask = tasks
    rng = np.random.default_rng(2)
    batch = (rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8), np.array([2, 0, 1], np.int32))
    t = np.array([0.2, 0.5, 0.9], np.float32)
    eps = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    src, tgt, y = jtask.prepare_batch(tuple(jnp.asarray(b) for b in batch), jax.random.key(0))
    matcher = JaxFlowMatcher(sigma=0.1)

    def loss_fn(p):
        xt = (1 - t[:, None, None, None]) * src + t[:, None, None, None] * tgt + 0.1 * eps
        vt = jtask.net.apply({"params": p}, jnp.asarray(t), xt, y, train=True)
        return j_mse_loss(vt, matcher.conditional_flow(src, tgt, t))

    with jax.default_matmul_precision("highest"):
        ref = float(jax.jit(loss_fn)(variables["params"]))
    noisy = ClassConditionalFlowMatchingModule(net=ttask.net, flow_matcher=ConditionalFlowMatcher(sigma=0.1))
    prepared = noisy.prepare_batch(batch)
    assert prepared[2].dtype == torch.int64 and prepared[2].tolist() == [2, 0, 1]
    loss, metrics = noisy.loss_and_metrics(prepared, train=True, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(loss.item(), ref, atol=TOL, rtol=TOL)
    assert metrics["loss"].requires_grad is False
    # another label is another loss: the label reaches the net
    other = noisy.loss_and_metrics((prepared[0], prepared[1], (prepared[2] + 1) % 3), t=torch.from_numpy(t),
                                   eps=torch.from_numpy(eps))[0]
    assert abs(other.item() - loss.item()) > 1e-6


@pytest.mark.parametrize("target_class", [2, [1, 0]], ids=["one_class", "per_example"])
def test_generate_matches_jax(tasks, target_class):
    jtask, variables, ttask = tasks
    src = _source()
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtask.generate(variables, jnp.asarray(src), num_steps=3,
                                        target_class=jnp.asarray(target_class)))
    got = ttask.generate(torch.from_numpy(src), num_steps=3, target_class=torch.tensor(target_class))
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_generate_all_classes_matches_jax_and_per_class_generate(tasks):
    jtask, variables, ttask = tasks
    src = _source(3)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtask.generate_all_classes(variables, jnp.asarray(src), num_steps=2))
    got = ttask.generate_all_classes(torch.from_numpy(src), num_steps=2)
    assert got.shape == (3, 3, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)
    for c in range(3):
        per_class = ttask.generate(torch.from_numpy(src), num_steps=2, target_class=c)
        np.testing.assert_allclose(got[c].numpy(), per_class.numpy(), atol=1e-5, rtol=1e-5)
    assert (got[0] - got[1]).abs().max() > 1e-3  # the classes translate differently


def test_conditioned_tiled_generator_matches_jax(tasks):
    jtask, variables, ttask = tasks
    src = _source(2, seed=4)
    jgen = j_make_conditioned_tiled_generator(jtask, variables, num_steps=2)
    gen = make_conditioned_tiled_generator(ttask, num_steps=2)
    for c in (0, 2):
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jgen(src, c))
        got = gen(src, c)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_render_panels_use_each_examples_class(tasks):
    _, _, ttask = tasks
    rng = np.random.default_rng(5)
    batch = (rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8),
             rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8), np.array([2, 1], np.int32))
    panels = ttask.render_panels(batch, num_steps=2)
    src = ttask.prepare_batch(batch)[0]
    want = ttask.generate(src, num_steps=2, target_class=torch.tensor([2, 1]))
    np.testing.assert_allclose(panels["generated"], torch.clamp((want + 1) * 0.5, 0, 1).numpy(), atol=1e-6)
    assert set(panels) == {"source", "generated", "target"}


# ------------------------------------------------------------------ serving


def test_class_conditioned_server_over_http(tasks):
    _, _, ttask = tasks
    server = TranslationServer(ttask, num_steps=2, tile=SIZE, overlap=4, batch=2, target_class=1)
    assert server.info["class_conditioned"] is True and server.info["target_class"] == 1
    img = np.random.default_rng(8).integers(0, 256, size=(20, 26, 3), dtype=np.uint8)
    want = {c: server.translate(img, target_class=c) for c in range(3)}
    np.testing.assert_array_equal(server.translate(img), want[1])  # the default class
    assert np.abs(want[0] - want[2]).max() > 1e-3
    ready = threading.Event()
    thread = threading.Thread(target=serve_forever, args=(server, "127.0.0.1", 0, ready), daemon=True)
    thread.start()
    try:
        assert ready.wait(30)
        base = f"http://127.0.0.1:{server.bound_port}"
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        for query, cls in (("?target_class=0", 0), ("?target_class=2", 2), ("", 1)):
            req = urllib.request.Request(f"{base}/translate{query}", data=buf.getvalue(),
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = np.asarray(Image.open(io.BytesIO(resp.read())))
            np.testing.assert_array_equal(out, (want[cls] * 255).astype(np.uint8))
        for bad in ("?target_class=3", "?target_class=x"):
            req = urllib.request.Request(f"{base}/translate{bad}", data=buf.getvalue(),
                                         headers={"Content-Type": "image/png"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=30)
            assert err.value.code == 400
        info = json.loads(urllib.request.urlopen(f"{base}/info", timeout=30).read())
        assert info["target_class"] == 1 and info["class_conditioned"] is True
    finally:
        server.httpd.shutdown()
        thread.join(timeout=10)
    assert not thread.is_alive()


# -------------------------------------------------------------- entry points

NET = ["model.net.dim=[3,32,32]", "model.net.num_channels=8", "model.net.num_res_blocks=1",
       "model.net.channel_mult=[1,2]", "model.net.attention_resolutions=''", "model.net.num_heads=1",
       "model.net.dropout=0.0", "model.solver.solver=euler"]


def test_any2any_trains_through_the_entry_point_and_infers_every_class(tmp_path, monkeypatch):
    from stain2stain_tpu_torch import infer_any2any

    data = generate_domain_folders(tmp_path / "domains", n_images=12, size=40, seed=0)
    cfg = compose(REPO_ROOT / "configs", "train.yaml",
                  ["experiment=smoke_any2any", "trainer=cpu", f"data.data_dir={data}", "logger=csv"])
    (tmp_path / "out").mkdir()
    cfg["runtime"] = {"output_dir": str(tmp_path / "out"), "cwd": str(tmp_path)}
    cfg["extras"]["print_config"] = False
    cfg["extras"]["enforce_tags"] = False
    metrics, objects = train(cfg)
    assert type(objects["model"]).__name__ == "ClassConditionalFlowMatchingModule"
    assert type(objects["datamodule"]).__name__ == "ClassConditionalAnyToAnyDataModule"
    assert objects["trainer"].global_step == 4  # 9 training tiles / batch 4, 2 epochs
    assert all(np.isfinite(metrics[k]) for k in ("train/loss", "val/loss", "test/loss"))

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    best = objects["trainer"].checkpoint_callback.best_model_path
    panels = infer_any2any.main([
        "model=class_conditional_flow_matching", "data=class_conditional_he_amyloid", f"data.data_dir={data}",
        "data.class_folder_mapping={0: HE, 1: IHC, 2: Grayscale}", "data.crop_size=32", "data.batch_size=2",
        "device=cpu", f"ckpt_path={best}", "num_steps=2", "n_images=3", *NET])
    files = sorted(panels.iterdir())
    assert len(files) == 3
    # source | to_class_0 | to_class_1 | to_class_2
    assert np.asarray(Image.open(files[0])).shape == (32, 4 * 32, 3)

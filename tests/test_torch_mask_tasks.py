"""The port's mask-conditioned CFM tasks against the JAX package's, on the CPU.

- Losses: ``roi_weighted_mse``, ``charbonnier`` and ``roi_charbonnier``
  against JAX's at 1e-5, an all-zero mask included.
- ``prepare_batch`` with a mask field: JAX's conversion ((B, H, W) uint8 →
  f32 (B, H, W, 1)), and one crop and flip shared by images and mask, with
  the draws replayed from the same generator.
- Nets: ``UNet4to3`` and the configs' 4-channel ``UNetModel`` with list
  (raw-ds) attention at level 2, weights carried by ``compat``, forward at
  3e-4 under ``jax.default_matmul_precision("highest")``.
- Tasks (masked, ROI-Charbonnier, mask-conditioned, toggled mask with each
  coin, aux-fraction): ``loss_and_metrics`` with JAX's t, path noise and
  toggle coin injected, and ``generate`` (euler, 2 steps), at 3e-4; the
  conditioned task refuses to generate without a mask, the toggled one
  generates on a zero mask; the server serves the toggled task and refuses
  the conditioned one, unless a mask is bound into it (``mask=``), which it
  then serves as JAX's server does, at 3e-4.
- The aux head: trained by the optimizer, saved and restored with the
  checkpoint; a checkpoint without heads still loads into a plain task.
- Panels: the ``"mask"`` panel, written gray by the file logger.
- Entry points: ``experiment=he2ihc_masked_conditioned trainer=cpu`` at tiny
  width for 2 steps, then ``infer_conditional`` on its checkpoint with the
  mask and with ``+zero_mask=true``.
- Every module of the port imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import stain2stain_tpu_torch
from stain2stain_tpu.models import UNet4to3 as JaxUNet4to3
from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops import losses as jlosses
from stain2stain_tpu.ops.cfm import ConditionalFlowMatcher as JaxFlowMatcher
from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
from stain2stain_tpu.tasks import AuxFractionFlowMatchingModule as JaxAux
from stain2stain_tpu.tasks import MaskConditionedFlowMatchingModule as JaxConditioned
from stain2stain_tpu.tasks import MaskedFlowMatchingModule as JaxMasked
from stain2stain_tpu.tasks import ROICharbonnierFlowMatchingModule as JaxROI
from stain2stain_tpu.tasks import ToggleMaskFlowMatchingModule as JaxToggle
from stain2stain_tpu_torch.compat import (
    frac_head_state_dict_from_flax,
    unet_4to3_state_dict_from_flax,
    unet_state_dict_from_flax,
)
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset
from stain2stain_tpu_torch.models import UNet4to3, UNetModel
from stain2stain_tpu_torch.ops import losses
from stain2stain_tpu_torch.ops.cfm import ConditionalFlowMatcher
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.server import TranslationServer
from stain2stain_tpu_torch.tasks import (
    AuxFractionFlowMatchingModule,
    ConditionalFlowMatchingModule,
    MaskConditionedFlowMatchingModule,
    MaskedFlowMatchingModule,
    ROICharbonnierFlowMatchingModule,
    ToggleMaskFlowMatchingModule,
)
from stain2stain_tpu_torch.train import train
from stain2stain_tpu_torch.training import CheckpointIO, FileLogger, TrainState
from stain2stain_tpu_torch.training import optim as toptim

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-4  # nets: f32 on both sides, summation order only
OP_TOL = 1e-5
SIZE = 16
# 3 levels, 8 channels, attention as raw ds 4 (level 2) and in the mid block
TINY = dict(num_channels=8, num_res_blocks=1, channel_mult=(1, 2, 2), attention_resolutions=[4], num_head_channels=8)
SIGMA = 0.1  # a noisy path, so the injected noise reaches the loss


# ------------------------------------------------------------------- losses


def _loss_inputs(seed: int, mask_kind: str):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    target = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    mask = {"binary": (rng.random((2, 8, 8, 1)) > 0.6), "soft": rng.random((2, 8, 8, 1)),
            "zero": np.zeros((2, 8, 8, 1)), "ones": np.ones((2, 8, 8, 1))}[mask_kind].astype(np.float32)
    return pred, target, mask


@pytest.mark.parametrize("mask_kind", ["binary", "soft", "zero", "ones"])
@pytest.mark.parametrize("loss", ["roi_weighted_mse", "roi_charbonnier", "charbonnier"])
def test_losses_match_jax(loss, mask_kind):
    pred, target, mask = _loss_inputs(0, mask_kind)
    if loss == "charbonnier":
        got = losses.charbonnier(torch.from_numpy(pred), torch.from_numpy(target), eps=1e-2).numpy()
        ref = np.asarray(jlosses.charbonnier(jnp.asarray(pred), jnp.asarray(target), eps=1e-2))
        np.testing.assert_allclose(got, ref, atol=OP_TOL, rtol=OP_TOL)
        return
    kw = {"roi_lambda": 7.0} if loss == "roi_weighted_mse" else {"eps": 1e-3}
    got = getattr(losses, loss)(*(torch.from_numpy(a) for a in (pred, target, mask)), **kw)
    ref = getattr(jlosses, loss)(*(jnp.asarray(a) for a in (pred, target, mask)), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(ref), atol=OP_TOL, rtol=OP_TOL)
    if mask_kind == "zero":
        # no ROI pixels: the weighted MSE is the plain MSE, the ROI mean 0
        want = np.mean((pred - target) ** 2) if loss == "roi_weighted_mse" else 0.0
        np.testing.assert_allclose(got.item(), want, atol=OP_TOL, rtol=OP_TOL)


# ------------------------------------------------------------ prepare_batch


def _uint8_batch(seed: int, batch: int = 3, size: int = SIZE, mask_3d: bool = True) -> tuple:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    tgt = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    mask = (rng.random((batch, size, size) if mask_3d else (batch, size, size, 1)) > 0.5).astype(np.uint8)
    return src, tgt, mask


def test_prepare_batch_converts_the_mask_as_jax():
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", **TINY)
    task = MaskedFlowMatchingModule(net=net)
    jtask = JaxMasked(net=None)
    for mask_3d in (True, False):
        batch = _uint8_batch(1, mask_3d=mask_3d)
        got = task.prepare_batch(batch)
        ref = jtask.prepare_batch(tuple(jnp.asarray(b) for b in batch), jax.random.key(0), train=False)
        assert got[2].dtype == torch.float32 and tuple(got[2].shape) == (3, SIZE, SIZE, 1)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # a class-mask field keeps its integer ids, (B, H, W), as JAX's does
    task.batch_fields = jtask.batch_fields = ("image", "image", "class_mask")
    batch = _uint8_batch(1)
    got = task.prepare_batch(batch)
    ref = jtask.prepare_batch(tuple(jnp.asarray(b) for b in batch), jax.random.key(0), train=False)
    assert got[2].dtype == torch.int64 and tuple(got[2].shape) == (3, SIZE, SIZE)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_prepare_batch_crops_images_and_mask_together():
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", **TINY)
    task = MaskedFlowMatchingModule(net=net)
    src, tgt, mask = _uint8_batch(2, batch=4, size=24)
    got = task.prepare_batch((src, tgt, mask), torch.Generator().manual_seed(11), train=True,
                             augment={"crop_size": SIZE, "hflip": True, "vflip": True})
    # replay the draws (tops, lefts, h flips, v flips) from the same generator
    g = torch.Generator().manual_seed(11)
    tops, lefts = (torch.randint(0, 24 - SIZE + 1, (4,), generator=g).numpy() for _ in range(2))
    flip_h, flip_v = (torch.rand((4,), generator=g).numpy() < 0.5 for _ in range(2))
    assert flip_h.any() and (~flip_h).any()
    want = []
    for x in (src.astype(np.float32) / 127.5 - 1.0, tgt.astype(np.float32) / 127.5 - 1.0,
              mask[..., None].astype(np.float32)):
        rows = []
        for b in range(4):
            y = x[b, tops[b]:tops[b] + SIZE, lefts[b]:lefts[b] + SIZE]
            y = y[:, ::-1] if flip_h[b] else y
            rows.append(y[::-1] if flip_v[b] else y)
        want.append(np.stack(rows))
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), w)


# --------------------------------------------------------------------- nets


def _jitter(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
                                  params)


def _nets(kind: str, seed: int = 0):
    """(flax net, jittered params, port net with the same weights) of ``kind``:
    ``unet3`` (the plain UNet), ``unet4`` (the configs' 4-channel UNetModel)
    or ``unet_4to3`` (the ``UNet4to3`` wrapper)."""
    in_ch = 3 if kind == "unet3" else 4
    if kind == "unet_4to3":
        jnet = JaxUNet4to3(image_size=SIZE, dropout=0.0, dtype=jnp.float32, **TINY)
    else:
        jnet = JaxUNet(dim=(in_ch, SIZE, SIZE), out_channels=3, fused_attention=False, dtype=jnp.float32,
                       dropout=0.0, **TINY)
    x = jnp.zeros((2, SIZE, SIZE, in_ch))
    params = _jitter(jax.jit(jnet.init)(jax.random.key(seed), jnp.zeros((2,)), x)["params"], seed)
    if kind == "unet_4to3":
        tnet = UNet4to3(image_size=SIZE, dropout=0.0, device="cpu", **TINY)
        sd = unet_4to3_state_dict_from_flax(params, image_size=SIZE, **TINY)
    else:
        tnet = UNetModel(dim=(in_ch, SIZE, SIZE), out_channels=3, dropout=0.0, device="cpu", **TINY)
        sd = unet_state_dict_from_flax(params, image_size=SIZE, **TINY)
    tnet.load_state_dict(sd, strict=True)
    return jnet, params, tnet


@pytest.mark.parametrize("kind", ["unet_4to3", "unet4"])
def test_mask_conditioned_net_with_level_attention_matches_jax(kind):
    jnet, params, tnet = _nets(kind)
    # attention at level 2 (its one down unit and two up units) and in the mid block
    from stain2stain_tpu_torch.models.unet import AttentionBlock

    assert sum(isinstance(m, AttentionBlock) for m in tnet.modules()) == 4
    if kind == "unet_4to3":
        assert all(k.startswith("unet.") for k in tnet.state_dict())
    x = np.random.default_rng(3).uniform(-1, 1, (2, SIZE, SIZE, 4)).astype(np.float32)
    t = np.array([0.25, 0.8], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(t), jnp.asarray(x)))
    got = tnet(torch.from_numpy(t), torch.from_numpy(x))
    assert got.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=TOL, rtol=TOL)


# -------------------------------------------------------------------- tasks

TASKS = {  # name: (JAX class, port class, net kind, extra kwargs)
    "masked": (JaxMasked, MaskedFlowMatchingModule, "unet3", {"roi_lambda": 10.0}),
    "roi": (JaxROI, ROICharbonnierFlowMatchingModule, "unet3", {"lambda_roi": 2.0}),
    "conditioned": (JaxConditioned, MaskConditionedFlowMatchingModule, "unet_4to3", {}),
    "toggle": (JaxToggle, ToggleMaskFlowMatchingModule, "unet_4to3", {"toggle_prob": 0.5}),
    "aux": (JaxAux, AuxFractionFlowMatchingModule, "unet3", {"aux_loss_weight": 0.5}),
}


def _tasks(name: str):
    """(JAX task, its variables, port task): the same weights, a noisy path."""
    jcls, tcls, kind, kw = TASKS[name]
    jnet, params, tnet = _nets(kind, seed=1)
    jtask = jcls(net=jnet, flow_matcher=JaxFlowMatcher(sigma=SIGMA), solver=JaxSolverConfig("euler"), **kw)
    ttask = tcls(net=tnet, flow_matcher=ConditionalFlowMatcher(sigma=SIGMA), solver=SolverConfig("euler"), **kw)
    variables = {"params": params}
    if name == "aux":
        head_vars = jtask.init_variables(jax.random.key(2), (jnp.zeros((2, SIZE, SIZE, 3)),))
        head = _jitter(head_vars["params"]["frac_head"], 2)
        variables = {"params": {**params, "frac_head": head}}
        ttask.frac_head.load_state_dict(frac_head_state_dict_from_flax(head))
    return jtask, variables, ttask


def _jax_draws(key, splits: int, shape):
    """The t, path noise and (3 splits) toggle coin JAX's loss draws from ``key``."""
    keys = jax.random.split(key, splits)
    t_rng, x_rng = jax.random.split(keys[0])
    t = np.array(jax.random.uniform(t_rng, (shape[0],), jnp.float32))
    eps = np.array(jax.random.normal(x_rng, shape, jnp.float32))
    coin = bool(jax.random.bernoulli(keys[2], 0.5)) if splits == 3 else None
    return t, eps, coin


@pytest.mark.parametrize("name,coin", [("masked", None), ("roi", None), ("conditioned", None), ("toggle", True),
                                       ("toggle", False), ("aux", None)])
def test_loss_and_metrics_match_jax(name, coin):
    jtask, variables, ttask = _tasks(name)
    batch = _uint8_batch(4)
    jbatch = jtask.prepare_batch(tuple(jnp.asarray(b) for b in batch), jax.random.key(0))
    prepared = ttask.prepare_batch(batch)
    splits = 3 if name == "toggle" else 2
    seed = 0
    while True:  # a key whose toggle coin is the one asked for
        key = jax.random.key(seed)
        t, eps, drawn = _jax_draws(key, splits, prepared[0].shape)
        if drawn == coin:
            break
        seed += 1
    with jax.default_matmul_precision("highest"):
        ref_loss, ref_metrics, _ = jax.jit(lambda v, b, k: jtask.loss_and_metrics(v, b, k, train=True))(
            variables, jbatch, key)
    extra = {"coin": coin} if name == "toggle" else {}
    loss, metrics = ttask.loss_and_metrics(prepared, train=True, t=torch.from_numpy(t), eps=torch.from_numpy(eps),
                                           **extra)
    assert set(metrics) == set(ref_metrics)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=TOL, rtol=TOL)
    for k, v in metrics.items():
        assert not v.requires_grad
        np.testing.assert_allclose(v.item(), float(ref_metrics[k]), atol=TOL, rtol=TOL)
    if name == "roi":  # xt is sampled, not predicted: the Charbonnier term has no parameter gradient
        assert metrics["roi_charbonnier"].item() > 0
    if name == "toggle":
        assert ttask.coins == {"drawn": 1, "zeroed": int(coin)}
        # the coin zeroes the whole batch's mask: the same loss as a zero mask, unconditioned
        zeroed = (prepared[0], prepared[1], torch.zeros_like(prepared[2]))
        plain = ttask.loss_and_metrics(zeroed, t=torch.from_numpy(t), eps=torch.from_numpy(eps))[0]
        assert (abs(plain.item() - loss.item()) < 1e-6) == coin


def test_toggle_coin_comes_from_the_step_generator():
    _, _, ttask = _tasks("toggle")
    prepared = ttask.prepare_batch(_uint8_batch(5))
    coins = []
    for seed in range(16):
        g = torch.Generator().manual_seed(seed)
        want = bool(torch.rand((), generator=torch.Generator().manual_seed(seed)) < 0.5)
        before = dict(ttask.coins)
        ttask.loss_and_metrics(prepared, g, train=True)
        coins.append(ttask.coins["zeroed"] - before["zeroed"] == 1)
        assert coins[-1] == want and ttask.coins["drawn"] == before["drawn"] + 1
    assert any(coins) and not all(coins)
    before = dict(ttask.coins)
    ttask.loss_and_metrics(prepared, torch.Generator().manual_seed(0), train=False)
    assert ttask.coins == before  # no coin outside training


@pytest.mark.parametrize("name", list(TASKS))
def test_generate_matches_jax(name):
    jtask, variables, ttask = _tasks(name)
    rng = np.random.default_rng(6)
    src = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    mask = (rng.random((2, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    kw = {"mask": mask} if name in ("conditioned", "toggle") else {}
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtask.generate(variables, jnp.asarray(src), num_steps=2,
                                        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = ttask.generate(torch.from_numpy(src), num_steps=2, **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_generate_without_a_mask():
    _, _, conditioned = _tasks("conditioned")
    src = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="requires the conditioning mask"):
        conditioned.generate(src, num_steps=2)
    ones = conditioned.generate(src, num_steps=2, mask=torch.ones(2, SIZE, SIZE, 1))
    zeros = conditioned.generate(src, num_steps=2, mask=torch.zeros(2, SIZE, SIZE, 1))
    assert (ones - zeros).abs().max() > 1e-3  # the mask reaches the net
    _, _, toggle = _tasks("toggle")
    np.testing.assert_array_equal(toggle.generate(src, num_steps=2).numpy(),
                                  toggle.generate(src, num_steps=2, mask=torch.zeros(2, SIZE, SIZE, 1)).numpy())
    # one (H, W, 3) tile and its (H, W, 1) mask
    single = conditioned.generate(src[0], num_steps=2, mask=torch.ones(SIZE, SIZE, 1))
    np.testing.assert_allclose(single.numpy(), ones[:1].numpy(), atol=1e-6)


def test_server_serves_the_toggled_task_and_refuses_the_conditioned_one():
    _, _, toggle = _tasks("toggle")
    server = TranslationServer(toggle, num_steps=2, tile=SIZE, overlap=4, batch=2)
    img = np.random.default_rng(8).integers(0, 256, size=(20, 26, 3), dtype=np.uint8)
    out = server.translate(img)
    assert out.shape == (20, 26, 3) and server.info["class_conditioned"] is False
    tile = img[:SIZE, :SIZE].astype(np.float32) / 127.5 - 1.0
    want = torch.clamp((toggle.generate(torch.from_numpy(tile), num_steps=2) + 1) * 0.5, 0, 1)[0]
    # a single-tile request is that tile's zero-mask translation
    np.testing.assert_allclose(server.translate(img[:SIZE, :SIZE]), want.numpy(), atol=1e-5)
    _, _, conditioned = _tasks("conditioned")
    with pytest.raises(ValueError, match="requires the conditioning mask"):
        TranslationServer(conditioned, num_steps=2, tile=SIZE, overlap=4, batch=2)


def test_server_binds_a_fixed_mask_as_jax():
    """``TranslationServer(task, …, mask=m)`` binds the mask into every tile
    batch's ``generate``, as JAX ``server.py:67, :90-94``: both packages
    serve the mask-conditioned task with a fixed zero mask on one region
    alike; a ones mask serves another image."""
    from stain2stain_tpu.server import TranslationServer as JaxTranslationServer

    jtask, variables, conditioned = _tasks("conditioned")
    img = np.random.default_rng(11).integers(0, 256, size=(20, 26, 3), dtype=np.uint8)
    zeros = np.zeros((2, SIZE, SIZE, 1), np.float32)
    with jax.default_matmul_precision("highest"):
        ref = JaxTranslationServer(jtask, variables, num_steps=2, tile=SIZE, overlap=4, batch=2,
                                   mask=jnp.asarray(zeros)).translate(img)
    got = TranslationServer(conditioned, num_steps=2, tile=SIZE, overlap=4, batch=2, mask=zeros).translate(img)
    assert got.shape == (20, 26, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    ones = TranslationServer(conditioned, num_steps=2, tile=SIZE, overlap=4, batch=2,
                             mask=torch.ones(2, SIZE, SIZE, 1)).translate(img)
    assert np.abs(ones - got).max() > 1e-3


# ------------------------------------------------------------ the aux head


def test_aux_head_is_trained_and_checkpointed(tmp_path):
    _, _, task = _tasks("aux")
    task.optimizer = lambda params: toptim.Adam(params, lr=1e-2)
    opt, _ = task.configure_optimizers()
    in_opt = {id(p) for group in opt.param_groups for p in group["params"]}
    assert {id(p) for p in task.frac_head.parameters()} <= in_opt
    assert len(in_opt) == len(list(task.net.parameters())) + 2
    before = task.frac_head.weight.detach().clone()
    loss, _ = task.loss_and_metrics(task.prepare_batch(_uint8_batch(9)), torch.Generator().manual_seed(0), train=True)
    loss.backward()
    opt.step()
    assert not torch.equal(before, task.frac_head.weight)

    io = CheckpointIO()
    io.save(tmp_path / "ckpt", TrainState(step=1, net=task.net, optimizer=opt, heads=task.heads), {"epoch": 0})
    saved = torch.load(tmp_path / "ckpt" / "state.pt", weights_only=True)
    assert set(saved["heads"]) == {"frac_head"} and set(saved["model"]) == set(task.net.state_dict())
    _, _, fresh = _tasks("aux")
    with torch.no_grad():
        fresh.frac_head.weight.zero_()
    fresh.optimizer = task.optimizer
    fresh_opt, _ = fresh.configure_optimizers()
    state = TrainState(step=0, net=fresh.net, optimizer=fresh_opt, heads=fresh.heads)
    io.restore(tmp_path / "ckpt", state)
    assert state.step == 1
    torch.testing.assert_close(fresh.frac_head.weight, task.frac_head.weight, rtol=0, atol=0)
    torch.testing.assert_close(fresh_opt.state_dict()["state"], opt.state_dict()["state"], rtol=0, atol=0)

    # a checkpoint written before heads existed: no "heads" key
    plain = ConditionalFlowMatchingModule(net=fresh.net)
    plain.optimizer = task.optimizer
    plain_opt, _ = plain.configure_optimizers()
    old = tmp_path / "old"
    old.mkdir()
    torch.save({"step": 3, "model": task.net.state_dict(), "optimizer": plain_opt.state_dict()}, old / "state.pt")
    plain_state = TrainState(step=0, net=plain.net, optimizer=plain_opt, heads=plain.heads)
    io.restore(old, plain_state)
    assert plain_state.step == 3
    with pytest.raises(KeyError, match="frac_head"):
        io.restore(old, state)


# ------------------------------------------------------------------ panels


def test_mask_panel_is_rendered_and_logged(tmp_path):
    _, _, task = _tasks("conditioned")
    task.n_images_log = 2
    panels = task.render_panels(_uint8_batch(10), torch.Generator().manual_seed(0), num_steps=2)
    assert set(panels) == {"source", "generated", "target", "mask"}
    assert panels["mask"].shape == (2, SIZE, SIZE, 1) and panels["generated"].shape == (2, SIZE, SIZE, 3)
    logger = FileLogger(save_dir=str(tmp_path))
    logger.log_images("val", panels, step=3)
    logger.finalize()
    gray = np.asarray(Image.open(tmp_path / "file" / "images" / "step_3" / "val_mask_0.png"))
    assert gray.shape == (SIZE, SIZE)
    np.testing.assert_array_equal(gray, (panels["mask"][0, ..., 0] * 255).astype(np.uint8))


# -------------------------------------------------------------- entry points

NET = ["model.net.dim=[4,16,16]", "model.net.num_channels=8", "model.net.num_res_blocks=1",
       "model.net.channel_mult=[1,2]", "model.net.attention_resolutions=[2]", "model.net.num_head_channels=8",
       "model.solver.solver=euler"]


def test_masked_conditioned_trains_through_the_entry_point_and_infers(tmp_path, monkeypatch):
    from stain2stain_tpu_torch import infer_conditional

    data = generate_paired_dataset(tmp_path / "tiles", n_train=4, n_val=2, n_test=2, size=16, seed=0, with_mask=True)
    data_kw = [f"data.data_dir={data}", "data.csv_file_name=metadata.csv", "data.image_size=16", "data.batch_size=2",
               "data.num_workers=2"]
    cfg = compose(REPO_ROOT / "configs", "train.yaml",
                  ["experiment=he2ihc_masked_conditioned", "trainer=cpu", "trainer.devices=1", "trainer.min_epochs=0",
                   "trainer.max_epochs=1", "callbacks.model_checkpoint.every_n_epochs=1", "test=true",
                   *data_kw, *NET])
    (tmp_path / "out").mkdir()
    cfg["runtime"] = {"output_dir": str(tmp_path / "out"), "cwd": str(tmp_path)}
    cfg["extras"]["print_config"] = False
    cfg["extras"]["enforce_tags"] = False
    metrics, objects = train(cfg)
    task = objects["model"]
    assert type(task).__name__ == "ToggleMaskFlowMatchingModule"
    assert type(objects["datamodule"]).__name__ == "PairedHEIHCDataModule"
    assert objects["trainer"].global_step == 2 and task.coins["drawn"] == 2
    assert all(np.isfinite(metrics[k]) for k in ("train/loss", "val/loss", "test/loss"))
    best = objects["trainer"].checkpoint_callback.best_model_path
    assert best and (Path(best) / "state.pt").is_file()

    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    infer = ["model=conditional_flow_matching_mask_toggeling", "data=paired_data_mask_he_amyloid", *data_kw,
             "device=cpu", f"ckpt_path={best}", "num_steps=2", "n_images=2", *NET]
    runs = {}
    for extra in ([], ["+zero_mask=true"]):
        panels = infer_conditional.main(infer + extra)
        files = sorted(panels.iterdir())
        assert len(files) == 2
        runs[bool(extra)] = [np.asarray(Image.open(f)) for f in files]
    for conditioned, zeroed in zip(runs[False], runs[True]):
        # source | generated | target | mask (gray, the real mask in both runs)
        assert conditioned.shape == zeroed.shape == (16, 4 * 16, 3)
        np.testing.assert_array_equal(conditioned[:, 48:], zeroed[:, 48:])
        assert set(np.unique(conditioned[:, 48:])) <= {0, 255}


def test_every_port_module_imports_nothing_of_jax():
    modules = sorted(m.name for m in pkgutil.walk_packages(stain2stain_tpu_torch.__path__, "stain2stain_tpu_torch."))
    for name in ("tasks.conditional_flow_matching_masked", "tasks.conditional_flow_matching_roi_loss",
                 "tasks.conditional_flow_matching_conditional_mask", "tasks.conditional_flow_matching_toggle_mask",
                 "tasks.conditional_flow_matching_aux_fraction", "models.unet_4to3", "data.paired_data_mask",
                 "data.paired_pos_neg", "infer_conditional", "parallel.distributed", "parallel.mesh",
                 "parallel.zero", "parallel.launch"):
        assert f"stain2stain_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', 'stain2stain_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'optax.', 'stain2stain_tpu.')))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

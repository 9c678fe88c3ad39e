"""The port's shared-encoder multitask family against the JAX package's, on the CPU.

- Losses: ``bce_with_logits``, ``dice_loss``, ``multiclass_dice_loss``,
  ``softmax_cross_entropy`` and ``per_class_dice_iou`` against JAX's at
  1e-5, with ``ignore_index`` pixels, an absent class and a batch whose
  every pixel is ignored.
- ``timestep_embedding_sincos`` at 1e-6; the corner-aligned bilinear ×2
  against JAX's two-lerp version at 1e-6, a one-pixel input included.
- Nets: ``SharedEncoder``, ``FlowMatchingDecoder``, ``SegmentationDecoder``
  and ``SegmentationUNet`` under ``norm="group"`` and ``"batch"``, train and
  eval, with JAX-initialized (jittered) weights carried across by
  ``compat``, at 3e-4 under ``jax.default_matmul_precision("highest")``;
  the BatchNorm running statistics after one train forward against JAX's
  ``batch_stats`` updates at 1e-6.
- Tasks (binary and multiclass, each norm): the fused 2B heads equal two
  separate forwards; ``loss_and_metrics`` in train and eval with JAX's t and
  path noise injected, at 3e-4, and the running statistics of the 2B pass;
  ``generate`` (euler, 2 steps): image and mask; ``prepare_batch`` with a
  class mask, converted as JAX does and cropped with the images.
- Weights: ``convert_multitask_state_dict`` ∘ ``multitask_state_dict_from_flax``
  is the identity bit for bit; the reference-layout oracle
  (``tests/helpers/multitask_torch.py``) loads strictly into the port, and
  its eval forward equals the port's.
- Entry points: ``experiment=smoke_multitask trainer=cpu`` under BatchNorm
  with exact resume (buffers included); the gray-matter experiment on a
  2-class tree; ``infer_multitask_multiclassloss`` on both checkpoints; the
  server's reduction of the ``(image, mask)`` tuple; the panels.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import stain2stain_tpu_torch
from stain2stain_tpu.compat.torch_multitask import convert_multitask_state_dict
from stain2stain_tpu.models import FlowMatchingDecoder as JaxFlowDecoder
from stain2stain_tpu.models import SegmentationDecoder as JaxSegDecoder
from stain2stain_tpu.models import SegmentationUNet as JaxSegUNet
from stain2stain_tpu.models import SharedEncoder as JaxEncoder
from stain2stain_tpu.models.task_decoders import _upsample_bilinear as j_upsample_bilinear
from stain2stain_tpu.ops import losses as jlosses
from stain2stain_tpu.ops.cfm import ConditionalFlowMatcher as JaxFlowMatcher
from stain2stain_tpu.ops.solvers import SolverConfig as JaxSolverConfig
from stain2stain_tpu.ops.time_embedding import timestep_embedding_sincos as j_sincos
from stain2stain_tpu.tasks import MultitaskFlowMatchingModule as JaxMultitask
from stain2stain_tpu.tasks import MultitaskMulticlassFlowMatchingModule as JaxMulticlass
from stain2stain_tpu.tasks.multitask import _module_vars
from stain2stain_tpu_torch.compat import multitask_state_dict_from_flax, segmentation_unet_state_dict_from_flax
from stain2stain_tpu_torch.config import compose
from stain2stain_tpu_torch.data.synthetic import generate_paired_dataset
from stain2stain_tpu_torch.models import FlowMatchingDecoder, SegmentationDecoder, SegmentationUNet, SharedEncoder
from stain2stain_tpu_torch.models.task_decoders import upsample_bilinear
from stain2stain_tpu_torch.ops import losses
from stain2stain_tpu_torch.ops.cfm import ConditionalFlowMatcher
from stain2stain_tpu_torch.ops.image import denormalize_np, normalize_uint8_np
from stain2stain_tpu_torch.ops.solvers import SolverConfig
from stain2stain_tpu_torch.ops.time_embedding import timestep_embedding_sincos
from stain2stain_tpu_torch.server import TranslationServer
from stain2stain_tpu_torch.tasks import MultitaskFlowMatchingModule, MultitaskMulticlassFlowMatchingModule, MultitaskNet
from stain2stain_tpu_torch.train import train
from stain2stain_tpu_torch.wsi import make_tiled_generator, translate_large_image
from tests.helpers import multitask_torch as oracle_mt

REPO_ROOT = Path(__file__).resolve().parent.parent
TOL = 3e-4  # nets: f32 on both sides, summation order only
OP_TOL = 1e-5
STATS_TOL = 1e-6
SIZE = 16
FEATS, DEC_FEATS, TEMB = (8, 16, 32), (16, 8), 16
SIGMA = 0.1  # a noisy path, so the injected noise reaches the loss
IGNORE = -100


def _x(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _nchw(a) -> torch.Tensor:
    return _x(a).permute(0, 3, 1, 2).contiguous()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------- losses


def _class_target(rng, case: str, num_classes: int = 3) -> np.ndarray:
    ids = rng.integers(0, num_classes, (2, 8, 8)).astype(np.int32)
    if case in ("ignored", "absent_class"):
        ids[rng.random((2, 8, 8)) < 0.25] = IGNORE
    if case == "absent_class":
        ids[ids == num_classes - 1] = 0  # the last class appears nowhere
    if case == "all_ignored":
        ids[:] = IGNORE
    if case == "stray_ids":  # ids outside [0, C): JAX's one-hot zero rows, its gather's wrap and NaN fill
        ids[0, 0, :2] = (num_classes, -2)
    return ids


@pytest.mark.parametrize("case", ["plain", "ignored", "absent_class", "all_ignored", "stray_ids"])
@pytest.mark.parametrize("loss", ["multiclass_dice_loss", "softmax_cross_entropy", "per_class_dice_iou"])
def test_multiclass_losses_match_jax(loss, case):
    rng = np.random.default_rng(0)
    logits = (2.0 * rng.standard_normal((2, 8, 8, 3))).astype(np.float32)
    target = _class_target(rng, case)
    kw = {"ignore_index": IGNORE}
    args = (logits, target) if loss == "softmax_cross_entropy" else (logits, target, 3)
    got = getattr(losses, loss)(*(_x(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    ref = getattr(jlosses, loss)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args), **kw)
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=OP_TOL, rtol=OP_TOL)
    if loss == "softmax_cross_entropy" and case == "all_ignored":
        assert got.item() == 0.0  # no valid pixel: 0, not NaN
    if loss == "softmax_cross_entropy" and case == "stray_ids":
        assert np.isnan(got.item())  # as JAX's: an id past the classes poisons the mean


@pytest.mark.parametrize("case", ["random", "empty", "full"])
@pytest.mark.parametrize("loss", ["bce_with_logits", "dice_loss"])
def test_binary_losses_match_jax(loss, case):
    rng = np.random.default_rng(1)
    logits = (3.0 * rng.standard_normal((2, 8, 8, 1))).astype(np.float32)
    target = {"random": rng.random((2, 8, 8, 1)) > 0.6, "empty": np.zeros((2, 8, 8, 1)),
              "full": np.ones((2, 8, 8, 1))}[case].astype(np.float32)
    got = getattr(losses, loss)(_x(logits), _x(target))
    ref = getattr(jlosses, loss)(jnp.asarray(logits), jnp.asarray(target))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(ref), atol=OP_TOL, rtol=OP_TOL)


@pytest.mark.parametrize("dim", [16, 17, 2])
def test_timestep_embedding_sincos_matches_jax(dim):
    t = np.random.default_rng(2).uniform(0, 1, (5,)).astype(np.float32)
    got = timestep_embedding_sincos(_x(t), dim)
    assert got.shape == (5, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_sincos(jnp.asarray(t), dim)), atol=1e-6, rtol=1e-6)


def _upsample_f64(x: np.ndarray) -> np.ndarray:
    """The corner-aligned ×2 in float64: out[o] samples the input at o·(in − 1)/(out − 1)."""
    out = x.astype(np.float64)
    for axis in (1, 2):
        n = out.shape[axis]
        src = np.arange(2 * n) * ((n - 1) / (2 * n - 1)) if n > 1 else np.zeros(2 * n)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n - 1)
        shape = [1] * out.ndim
        shape[axis] = 2 * n
        w = (src - lo).reshape(shape)
        out = np.take(out, lo, axis=axis) * (1 - w) + np.take(out, hi, axis=axis) * w
    return out


@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (4, 6), (7, 3), (32, 32)])
def test_bilinear_upsample_matches_jax(hw):
    # unit-scale inputs, the range of the images and of the normalized
    # activations: the f32 rounding of the lerps grows with |x|
    x = np.random.default_rng(3).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    got = _nhwc(upsample_bilinear(_nchw(x)))
    ref = np.asarray(j_upsample_bilinear(jnp.asarray(x)))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    if max(hw) <= 8:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
    else:
        # past a few pixels the two packages round the sampling coordinate
        # o·(in − 1)/(out − 1) differently (one f32 ulp of a value up to
        # in − 1), so a weight can differ by that ulp: each stays within it
        # of the exact float64 function
        exact = _upsample_f64(x)
        bound = 2 * np.spacing(np.float32(max(hw) - 1)) * 2 * np.abs(x).max() + 1e-6
        for y in (got, ref):
            assert np.abs(y - exact).max() <= bound


# --------------------------------------------------------------------- nets


def _jitter(tree, seed: int):
    """Params jittered, BatchNorm statistics made non-trivial (means around 0,
    variances in [0.5, 1.5]) so that a swapped or skipped tensor shows."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        leaf = np.asarray(leaf)
        name = getattr(path[-1], "key", "")
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "mean":
            return (0.2 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, tree)


def _jax_task(norm: str, multiclass: bool):
    seg_out = 3 if multiclass else 1
    kw = dict(
        encoder=JaxEncoder(3, FEATS, norm=norm),
        flow_decoder=JaxFlowDecoder(FEATS[-1], DEC_FEATS, 3, TEMB, norm=norm),
        seg_decoder=JaxSegDecoder(FEATS[-1], DEC_FEATS, seg_out, norm=norm),
        flow_matcher=JaxFlowMatcher(sigma=SIGMA), solver=JaxSolverConfig("euler"), time_emb_dim=TEMB,
    )
    return JaxMulticlass(**kw, num_classes=3, ignore_index=IGNORE) if multiclass else JaxMultitask(**kw)


def _port_task(norm: str, multiclass: bool):
    seg_out = 3 if multiclass else 1
    kw = dict(
        encoder=SharedEncoder(3, FEATS, norm=norm, device="cpu"),
        flow_decoder=FlowMatchingDecoder(FEATS[-1], DEC_FEATS, 3, TEMB, norm=norm, device="cpu"),
        seg_decoder=SegmentationDecoder(FEATS[-1], DEC_FEATS, seg_out, norm=norm, device="cpu"),
        flow_matcher=ConditionalFlowMatcher(sigma=SIGMA), solver=SolverConfig("euler"), time_emb_dim=TEMB,
    )
    if multiclass:
        return MultitaskMulticlassFlowMatchingModule(**kw, num_classes=3, ignore_index=IGNORE)
    return MultitaskFlowMatchingModule(**kw)


def _tasks(norm: str, multiclass: bool = False, seed: int = 0):
    """(JAX task, its jittered variables, port task with the same weights)."""
    jtask = _jax_task(norm, multiclass)
    variables = jtask.init_variables(jax.random.key(seed), (jnp.zeros((2, SIZE, SIZE, 3)),))
    variables = jax.device_get(_jitter(variables, seed))
    ttask = _port_task(norm, multiclass)
    ttask.net.load_state_dict(multitask_state_dict_from_flax(variables), strict=True)
    return jtask, variables, ttask


def _apply(module, variables, *args, train: bool):
    """A flax module's output in train or eval mode, with its new batch_stats (or {})."""
    with jax.default_matmul_precision("highest"):
        if train and "batch_stats" in variables:
            out, updates = module.apply(variables, *args, train=True, mutable=["batch_stats"])
            return out, updates["batch_stats"]
        return module.apply(variables, *args, train=train), {}


def _running_stats(module: torch.nn.Module) -> dict:
    return {k: v for k, v in module.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def _assert_running_stats(got: dict, want: dict) -> None:
    assert set(got) == set(want) and got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)


def _decoder_inputs(seed: int):
    rng = np.random.default_rng(seed)
    bottleneck = rng.standard_normal((2, SIZE // 4, SIZE // 4, FEATS[-1])).astype(np.float32)
    skips = [rng.standard_normal((2, SIZE // 2, SIZE // 2, FEATS[1])).astype(np.float32),
             rng.standard_normal((2, SIZE, SIZE, FEATS[0])).astype(np.float32)]
    t_emb = rng.standard_normal((2, TEMB)).astype(np.float32)
    return bottleneck, skips, t_emb


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("name", ["encoder", "flow_decoder", "seg_decoder"])
def test_shared_encoder_and_decoders_match_jax(name, norm, train_mode):
    jtask, variables, ttask = _tasks(norm)
    module = getattr(ttask.net, name)
    module.train(train_mode)
    jmodule = {"encoder": jtask.encoder, "flow_decoder": jtask.flow_decoder, "seg_decoder": jtask.seg_decoder}[name]
    if name == "encoder":
        x = np.random.default_rng(4).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
        (ref_b, ref_skips), ref_stats = _apply(jmodule, _module_vars(variables, name), jnp.asarray(x), train=train_mode)
        got_b, got_skips = module(_x(x))
        pairs = [(got_b, ref_b)] + list(zip(got_skips, ref_skips))
        assert [tuple(s.shape[1:]) for s in got_skips] == [(FEATS[1], 8, 8), (FEATS[0], SIZE, SIZE)]
    else:
        bottleneck, skips, t_emb = _decoder_inputs(5)
        jargs = (jnp.asarray(bottleneck), [jnp.asarray(s) for s in skips])
        targs = (_nchw(bottleneck), [_nchw(s) for s in skips])
        if name == "flow_decoder":
            jargs, targs = jargs + (jnp.asarray(t_emb),), targs + (_x(t_emb),)
        ref, ref_stats = _apply(jmodule, _module_vars(variables, name), *jargs, train=train_mode)
        got = module(*targs)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, SIZE, SIZE, 3 if name == "flow_decoder" else 1)
        pairs = [(got.permute(0, 3, 1, 2), ref)]
    for g, r in pairs:
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=TOL, rtol=TOL)
    if norm == "batch" and train_mode:
        want = multitask_state_dict_from_flax({"params": variables["params"],
                                               "batch_stats": {**variables["batch_stats"], name: ref_stats}})
        want = {k: v for k, v in want.items() if k.startswith(f"{name}.")}
        _assert_running_stats({f"{name}.{k}": v for k, v in _running_stats(module).items()},
                              {k: v for k, v in want.items() if k.endswith(("running_mean", "running_var"))})
        assert all(v.item() == 1 for k, v in module.state_dict().items() if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("norm", ["group", "batch"])
def test_segmentation_unet_matches_jax(norm, train_mode):
    # four pools of a 16-px tile: the bottleneck is one pixel, so the first
    # upsample takes the one-pixel branch
    feats = (8, 16, 32, 64)
    jnet = JaxSegUNet(3, 2, feats, norm=norm)
    x = np.random.default_rng(6).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = jax.device_get(_jitter(jnet.init(jax.random.key(1), jnp.asarray(x)), 1))
    net = SegmentationUNet(3, 2, feats, norm=norm, device="cpu")
    net.load_state_dict(segmentation_unet_state_dict_from_flax(variables), strict=True)
    net.train(train_mode)
    ref, ref_stats = _apply(jnet, variables, jnp.asarray(x), train=train_mode)
    got = net(_x(x))
    assert tuple(got.shape) == (2, SIZE, SIZE, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    if norm == "batch" and train_mode:
        want = segmentation_unet_state_dict_from_flax({"params": variables["params"], "batch_stats": ref_stats})
        _assert_running_stats(_running_stats(net),
                              {k: v for k, v in want.items() if k.endswith(("running_mean", "running_var"))})


# -------------------------------------------------------------------- tasks


def _uint8_batch(seed: int, multiclass: bool, batch: int = 2, size: int = SIZE) -> tuple:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    tgt = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    if multiclass:
        mask = rng.integers(0, 2, (batch, size, size)).astype(np.int32)  # class 2 absent
        mask[rng.random((batch, size, size)) < 0.2] = IGNORE
    else:
        mask = (rng.random((batch, size, size)) > 0.6).astype(np.uint8)
    return src, tgt, mask


def _jax_draws(key, shape):
    """The t and path noise JAX's multitask loss draws from ``key``."""
    fm_rng, _ = jax.random.split(key)
    t_rng, x_rng = jax.random.split(fm_rng)
    return (np.array(jax.random.uniform(t_rng, (shape[0],), jnp.float32)),
            np.array(jax.random.normal(x_rng, shape, jnp.float32)))


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_fused_heads_equal_two_forwards(norm):
    _, _, ttask = _tasks(norm)
    src, tgt, _ = ttask.prepare_batch(_uint8_batch(7, False))
    t = torch.tensor([0.3, 0.7])
    xt = 0.5 * (src + tgt)
    with torch.no_grad():
        vt, seg = ttask._fused_heads(t, xt, src, train=False)
        np.testing.assert_allclose(vt.numpy(), ttask.forward_flow(t, xt).numpy(), atol=1e-5)
        np.testing.assert_allclose(seg.numpy(), ttask.forward_segmentation(src).numpy(), atol=1e-5)
        if norm == "group":  # per-sample statistics: the 2B pass changes nothing in training mode either
            vt, seg = ttask._fused_heads(t, xt, src, train=True)
            np.testing.assert_allclose(vt.numpy(), ttask.forward_flow(t, xt, train=True).numpy(), atol=1e-5)
            np.testing.assert_allclose(seg.numpy(), ttask.forward_segmentation(src, train=True).numpy(), atol=1e-5)


@pytest.mark.parametrize("train_mode", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("multiclass", [False, True], ids=["binary", "multiclass"])
def test_loss_and_metrics_match_jax(multiclass, norm, train_mode):
    jtask, variables, ttask = _tasks(norm, multiclass, seed=2)
    batch = _uint8_batch(8, multiclass)
    jbatch = jtask.prepare_batch(tuple(jnp.asarray(b) for b in batch), jax.random.key(0))
    prepared = ttask.prepare_batch(batch)
    key = jax.random.key(9)
    t, eps = _jax_draws(key, prepared[0].shape)
    with jax.default_matmul_precision("highest"):
        ref_loss, ref_metrics, updates = jax.jit(
            lambda v, b, k: jtask.loss_and_metrics(v, b, k, train=train_mode))(variables, jbatch, key)
    loss, metrics = ttask.loss_and_metrics(prepared, train=train_mode, t=_x(t), eps=_x(eps))
    assert set(metrics) == set(ref_metrics)
    assert ("dice_coef" in metrics) == (not train_mode)
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=TOL, rtol=TOL)
    for k, v in metrics.items():
        assert not v.requires_grad
        np.testing.assert_allclose(v.item(), float(ref_metrics[k]), atol=TOL, rtol=TOL, err_msg=k)
    if norm == "batch" and train_mode:  # the 2B pass's statistics, every module's
        want = multitask_state_dict_from_flax({"params": variables["params"], **jax.device_get(updates)})
        _assert_running_stats(_running_stats(ttask.net),
                              {k: v for k, v in want.items() if k.endswith(("running_mean", "running_var"))})
    else:
        assert updates == {}
    if train_mode:
        loss.backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in ttask.net.parameters())


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("multiclass", [False, True], ids=["binary", "multiclass"])
def test_generate_matches_jax(multiclass, norm):
    jtask, variables, ttask = _tasks(norm, multiclass, seed=3)
    src = np.random.default_rng(10).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref_img, ref_mask = jtask.generate(variables, jnp.asarray(src), num_steps=2)
    img, mask = ttask.generate(_x(src), num_steps=2)
    assert img.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(ref_img), atol=TOL, rtol=TOL)
    if multiclass:
        assert mask.shape == (2, SIZE, SIZE) and mask.dtype == torch.int64
    else:
        assert mask.shape == (2, SIZE, SIZE, 1) and set(np.unique(mask.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    single_img, single_mask = ttask.generate(_x(src[0]), num_steps=2)  # one (H, W, 3) tile
    np.testing.assert_allclose(single_img.numpy(), img[:1].numpy(), atol=1e-5)  # conv sums by batch size
    np.testing.assert_array_equal(single_mask.numpy(), mask[:1].numpy())


@pytest.mark.parametrize("trailing_one", [False, True], ids=["bhw", "bhw1"])
def test_prepare_batch_converts_and_crops_the_class_mask(trailing_one):
    jtask, _, ttask = _tasks("group", multiclass=True)
    src, tgt, mask = _uint8_batch(11, True, batch=4, size=24)
    if trailing_one:
        mask = mask[..., None]
    got = ttask.prepare_batch((src, tgt, mask))
    ref = jtask.prepare_batch(tuple(jnp.asarray(b) for b in (src, tgt, mask)), jax.random.key(0))
    assert got[2].dtype == torch.int64 and tuple(got[2].shape) == (4, 24, 24)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # training: one crop and flip over the images and the ids; replay the
    # draws (tops, lefts, h flips, v flips) from the same generator
    got = ttask.prepare_batch((src, tgt, mask), torch.Generator().manual_seed(12), train=True,
                              augment={"crop_size": SIZE, "hflip": True, "vflip": True})
    g = torch.Generator().manual_seed(12)
    tops, lefts = (torch.randint(0, 24 - SIZE + 1, (4,), generator=g).numpy() for _ in range(2))
    flip_h, flip_v = (torch.rand((4,), generator=g).numpy() < 0.5 for _ in range(2))
    assert flip_h.any() and (~flip_h).any() and flip_v.any()
    ids = mask[..., 0] if trailing_one else mask
    for got_x, x in zip(got, (src.astype(np.float32) / 127.5 - 1.0, tgt.astype(np.float32) / 127.5 - 1.0, ids)):
        rows = []
        for b in range(4):
            y = x[b, tops[b]:tops[b] + SIZE, lefts[b]:lefts[b] + SIZE]
            y = y[:, ::-1] if flip_h[b] else y
            rows.append(y[::-1] if flip_v[b] else y)
        np.testing.assert_array_equal(got_x.numpy(), np.stack(rows))
    assert got[2].dtype == torch.int64 and IGNORE in got[2]


def test_panels_add_the_predicted_and_true_masks():
    for multiclass in (False, True):
        _, _, ttask = _tasks("batch", multiclass)
        ttask.n_images_log = 1
        panels = ttask.render_panels(_uint8_batch(13, multiclass), torch.Generator().manual_seed(0), num_steps=2)
        assert set(panels) == {"source", "generated", "target", "pred_mask", "gt_mask"}
        want = (1, SIZE, SIZE) if multiclass else (1, SIZE, SIZE, 1)
        assert panels["pred_mask"].shape == panels["gt_mask"].shape == want
        assert panels["pred_mask"].dtype == np.float32 and panels["generated"].shape == (1, SIZE, SIZE, 3)


def test_bf16_compute_is_set_on_every_network():
    _, _, ttask = _tasks("group")
    ttask.net.dtype = torch.bfloat16  # what the trainer sets under bf16-mixed
    assert {m.dtype for m in (ttask.net.encoder, ttask.net.flow_decoder, ttask.net.seg_decoder)} == {torch.bfloat16}
    prepared = ttask.prepare_batch(_uint8_batch(14, False))
    loss, _ = ttask.loss_and_metrics(prepared, torch.Generator().manual_seed(0), train=True)
    loss.backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in ttask.net.parameters())
    with pytest.raises(NotImplementedError, match="bilinear"):
        SegmentationDecoder(FEATS[-1], DEC_FEATS, 1, bilinear=False, device="cpu")


# ------------------------------------------------------------------ weights


def test_weight_conversion_round_trips_bit_for_bit():
    _, variables, ttask = _tasks("batch", multiclass=True, seed=4)
    sd = multitask_state_dict_from_flax(variables)
    assert set(sd) == set(ttask.net.state_dict())
    back = convert_multitask_state_dict(sd, features=FEATS, decoder_features=DEC_FEATS)
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_got]
    for (path, r), (_, g) in zip(flat_ref, flat_got):
        assert np.asarray(r).dtype == np.asarray(g).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=jax.tree_util.keystr(path))
    # the GroupNorm tree too (JAX's converter reads BatchNorm checkpoints only): every key, strictly
    _, g_vars, g_task = _tasks("group", seed=4)
    assert set(multitask_state_dict_from_flax(g_vars)) == set(g_task.net.state_dict())


def test_reference_layout_oracle_loads_into_the_port():
    torch.manual_seed(4)

    class Oracle(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder = oracle_mt.SharedEncoder(3, FEATS)
            self.flow_decoder = oracle_mt.FlowMatchingDecoder(FEATS[-1], DEC_FEATS, 3, TEMB)
            self.seg_decoder = oracle_mt.SegmentationDecoder(FEATS[-1], DEC_FEATS, 2)

    oracle = Oracle()
    oracle_mt.randomize_bn_stats(oracle, seed=5)
    oracle.eval()
    net = MultitaskNet(SharedEncoder(3, FEATS, norm="batch", device="cpu"),
                       FlowMatchingDecoder(FEATS[-1], DEC_FEATS, 3, TEMB, norm="batch", device="cpu"),
                       SegmentationDecoder(FEATS[-1], DEC_FEATS, 2, norm="batch", device="cpu"))
    net.load_state_dict(oracle.state_dict(), strict=True)
    net.eval()
    x = torch.randn(2, 3, SIZE, SIZE)
    t_emb = timestep_embedding_sincos(torch.tensor([0.3, 0.7]), TEMB)
    with torch.no_grad():
        bott, skips = oracle.encoder(x)
        ref_flow, ref_seg = oracle.flow_decoder(bott, skips, t_emb), oracle.seg_decoder(bott, skips)
        got_b, got_skips = net.encoder(x.permute(0, 2, 3, 1))
        got_flow, got_seg = net.flow_decoder(got_b, got_skips, t_emb), net.seg_decoder(got_b, got_skips)
    np.testing.assert_allclose(got_b.numpy(), bott.numpy(), atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(got_flow.permute(0, 3, 1, 2).numpy(), ref_flow.numpy(), atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_allclose(got_seg.permute(0, 3, 1, 2).numpy(), ref_seg.numpy(), atol=OP_TOL, rtol=OP_TOL)


# -------------------------------------------------------------- entry points

TINY = ["model.time_emb_dim=16", "model.encoder.features=[8,16]", "model.flow_decoder.bottleneck_channels=16",
        "model.flow_decoder.features=[8]", "model.flow_decoder.time_emb_dim=16",
        "model.seg_decoder.bottleneck_channels=16", "model.seg_decoder.features=[8]", "model.solver.solver=euler"]
BATCH_NORM = ["+model.encoder.norm=batch", "+model.flow_decoder.norm=batch", "+model.seg_decoder.norm=batch"]


def _cfg(tmp_path: Path, overrides: list, out: str):
    cfg = compose(REPO_ROOT / "configs", "train.yaml", overrides)
    (tmp_path / out).mkdir(exist_ok=True)
    cfg["runtime"] = {"output_dir": str(tmp_path / out), "cwd": str(tmp_path)}
    cfg["extras"]["print_config"] = False
    cfg["extras"]["enforce_tags"] = False
    return cfg


def _smoke(tmp_path: Path, extra: list, out: str):
    return _cfg(tmp_path, ["experiment=smoke_multitask", "trainer=cpu", f"data.data_dir={tmp_path}/synthetic",
                           "logger=csv", *BATCH_NORM, *extra], out)


@pytest.fixture(scope="module")
def gray_matter_run(tmp_path_factory):
    """``experiment=gray_matter/multitask_he2ihc_gray_matter`` at tiny width on a
    2-class synthetic tree: 2 steps, validation, test."""
    tmp = tmp_path_factory.mktemp("gray_matter")
    data = generate_paired_dataset(tmp / "tiles", n_train=4, n_val=2, n_test=2, size=24, seed=0, with_mask=True,
                                   num_mask_classes=2)
    data_kw = [f"data.data_dir={data}", "data.csv_file_name=metadata.csv", "data.target_column=ihc_filepath",
               "data.image_size=16", "data.batch_size=2", "data.num_workers=2"]
    cfg = _cfg(tmp, ["experiment=gray_matter/multitask_he2ihc_gray_matter", "trainer=cpu", "trainer.devices=1",
                     "trainer.min_epochs=0", "trainer.max_epochs=1", "callbacks.model_checkpoint.every_n_epochs=1",
                     "test=true", *data_kw, *TINY], "out")
    metrics, objects = train(cfg)
    return tmp, data_kw, metrics, objects


def test_smoke_multitask_trains_and_resumes_exactly_with_batchnorm(tmp_path):
    _, full = train(_smoke(tmp_path, ["trainer.max_epochs=2", "test=false"], "full"))
    _, first = train(_smoke(tmp_path, ["trainer.max_epochs=1", "test=false"], "first"))
    task = full["model"]
    assert type(task).__name__ == "MultitaskFlowMatchingModule" and isinstance(task.net, MultitaskNet)
    assert type(task.net.encoder.inc.double_conv[1]).__name__ == "BatchNorm2d"
    last = first["trainer"].checkpoint_callback.last_model_path
    saved = torch.load(Path(last) / "state.pt", weights_only=True)["model"]
    assert "encoder.inc.double_conv.1.running_var" in saved
    assert saved["encoder.inc.double_conv.1.num_batches_tracked"].item() == first["trainer"].global_step
    cfg = _smoke(tmp_path, ["trainer.max_epochs=2", "test=false"], "resumed")
    cfg["ckpt_path"] = last
    _, resumed = train(cfg)
    assert resumed["trainer"].global_step == full["trainer"].global_step == 4
    ref, got = full["model"].net.state_dict(), resumed["model"].net.state_dict()
    assert set(ref) == set(got) and any(k.endswith("running_mean") for k in ref)
    assert all(torch.equal(ref[k], got[k]) for k in ref)


def test_gray_matter_experiment_trains_on_the_multiclass_tree(gray_matter_run):
    _, _, metrics, objects = gray_matter_run
    task, dm = objects["model"], objects["datamodule"]
    assert type(task).__name__ == "MultitaskMulticlassFlowMatchingModule" and task.num_classes == 2
    assert type(dm).__name__ == "PairedMulticlassDataModule" and dm.train_augment is not None
    assert objects["trainer"].global_step == 2
    for k in ("train/loss", "train/seg_ce", "val/loss", "val/dice_coef", "val/iou", "test/loss", "test/iou"):
        assert np.isfinite(metrics[k]), k
    assert objects["trainer"].checkpoint_callback.best_model_path


def test_infer_cli_writes_panels_for_binary_and_multiclass_checkpoints(tmp_path, gray_matter_run, monkeypatch):
    from stain2stain_tpu_torch import infer_multitask_multiclassloss as infer

    _, first = train(_smoke(tmp_path, ["trainer.max_epochs=1", "test=false"], "out"))
    binary_ckpt = first["trainer"].checkpoint_callback.last_model_path
    gm_tmp, data_kw, _, gm_objects = gray_matter_run
    multiclass_ckpt = gm_objects["trainer"].checkpoint_callback.best_model_path
    runs = {
        "binary": ["model=conditional_flow_matching_multitask", "data=synthetic", f"data.data_dir={tmp_path}/synthetic",
                   "data.with_mask=true", "data.image_size=32", "data.tile_size=48", *BATCH_NORM,
                   f"ckpt_path={binary_ckpt}"],
        "multiclass": ["model=conditional_flow_matching_multitask_multiclass", "+num_classes=2",
                       "data=paired_data_multiclass_seg_mask", *data_kw, f"ckpt_path={multiclass_ckpt}"],
    }
    monkeypatch.setenv("PROJECT_ROOT", str(tmp_path))
    for kind, argv in runs.items():
        panels = infer.main(argv + ["device=cpu", "num_steps=2", "n_images=2", *TINY])
        files = sorted(panels.iterdir())
        assert len(files) == 2, kind
        size = 32 if kind == "binary" else 16
        for f in files:
            row = np.asarray(Image.open(f))
            # source | generated | target | predicted mask | true mask, the masks gray
            assert row.shape == (size, 5 * size, 3), kind
            pred = row[:, 3 * size:4 * size]
            assert set(np.unique(pred)) <= {0, 255}, kind
            assert np.array_equal(pred[..., 0], pred[..., 2])


def test_server_serves_the_flow_head_of_a_multitask_task():
    _, _, ttask = _tasks("batch", seed=5)
    server = TranslationServer(ttask, num_steps=2, tile=SIZE, overlap=4, batch=2)
    assert server.info["class_conditioned"] is False
    img = np.random.default_rng(15).integers(0, 256, size=(20, 26, 3), dtype=np.uint8)
    got = server.translate(img)

    def image_only(batch):
        return ttask.generate(torch.from_numpy(batch), num_steps=2)[0].numpy()

    want = denormalize_np(translate_large_image(image_only, normalize_uint8_np(img), tile=SIZE, overlap=4,
                                                batch_size=2))
    assert got.shape == (20, 26, 3)
    np.testing.assert_array_equal(got, want)
    gen = make_tiled_generator(ttask, num_steps=2)
    assert gen(np.zeros((2, SIZE, SIZE, 3), np.float32)).shape == (2, SIZE, SIZE, 3)


def test_the_new_modules_are_in_the_package_walk():
    import pkgutil

    modules = {m.name for m in pkgutil.walk_packages(stain2stain_tpu_torch.__path__, "stain2stain_tpu_torch.")}
    for name in ("models.shared_encoder", "models.task_decoders", "models.segmentation_unet", "compat.multitask",
                 "tasks.multitask", "tasks.multitask_multiclass", "data.paired_data_multiclassmask",
                 "infer_multitask_multiclassloss"):
        assert f"stain2stain_tpu_torch.{name}" in modules


@pytest.mark.parametrize("name", ["train-multitask", "train-multitask-multiclass"])
def test_chip_smoke_multitask_paths_compose_to_the_port_classes(name):
    """The card's multitask paths: the unchanged experiments with one card's
    cuts, the port's task and datamodule classes, BatchNorm on every module."""
    import chip_smoke

    overrides, data = chip_smoke.TRAIN_PATHS[name]
    cfg = compose(REPO_ROOT / "configs", "train.yaml", overrides + [f"data.data_dir=/tiles/{data}"])
    multiclass = name.endswith("multiclass")
    assert cfg["model"]["_target_"].endswith("MultitaskMulticlassFlowMatchingModule" if multiclass
                                              else "MultitaskFlowMatchingModule")
    assert cfg["data"]["_target_"].endswith("PairedMulticlassDataModule" if multiclass else "PairedHEIHCDataModule")
    assert int(cfg["data"]["batch_size"]) == (32 if multiclass else chip_smoke.MULTITASK_BATCH)
    assert int(cfg["data"]["image_size"]) == (256 if multiclass else 512)
    assert cfg["model"]["encoder"]["features"] == [64, 128, 256, 512, 1024]
    assert all(cfg["model"][m]["norm"] == "batch" for m in ("encoder", "flow_decoder", "seg_decoder"))
    assert cfg["trainer"]["devices"] == 1 and cfg["trainer"].get("precision") in (None, 32, "32")
    if multiclass:
        assert cfg["model"]["num_classes"] == 2 and cfg["model"]["seg_decoder"]["out_channels"] == 2

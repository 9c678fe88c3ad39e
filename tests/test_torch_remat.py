"""The port's UNet rematerialization (``use_checkpoint``), on the CPU.

- Port against port: one training step (dropout 0.1, seeds from one
  ``torch.Generator``) under every ``use_checkpoint`` mode gives the loss and
  every gradient of the step without remat, bit for bit (limit 1e-6 × max|g|:
  the recompute runs the same ops on the same inputs), and leaves the
  generator in the same state. On the plain f32 path (32 px, 2 levels, 8
  channels, attention at the second level and in the mid block; also with
  ``resblock_updown`` and pooled resampling) and on the fused bf16 path
  (``fused_conv=True``, 128 channels: K2–K5's plain versions).
- The regions hold what they should: under "level" the saved activations are
  a fraction of the no-remat ones, and remat runs only in training mode with
  grad enabled.
- Port against JAX: ``use_checkpoint="level"`` on both sides, converted
  weights, dropout 0: loss and gradients within 3e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.cfm import ConditionalFlowMatcher as JaxFlowMatcher
from stain2stain_tpu.ops.losses import mse_loss as j_mse_loss
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.models.unet import remat_mode

TOL = 3e-4  # port against JAX: f32 summation order only
SIZE = 32
PLAIN = dict(num_channels=8, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="16", num_head_channels=4)
FUSED = dict(num_channels=128, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="16",
             num_head_channels=32, resblock_updown=True)
MODES = [True, "block", "level", "block:1", "level:1", "block:2"]


def _step(use_checkpoint, kw: dict, dtype: str = "float32", fused: bool = False):
    """(loss, {name: grad}, generator state) of one training step."""
    torch.manual_seed(0)
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dropout=0.1, dtype=dtype, fused_conv=fused,
                    use_checkpoint=use_checkpoint, **kw).train()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # ADM zero-inits the output convs, which would hide a faulty block
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    x = torch.randn(2, SIZE, SIZE, 3, generator=gen)
    t = torch.tensor([0.3, 0.7])
    dropout_seeds = torch.Generator().manual_seed(5)
    loss = torch.mean(torch.square(net(t, x, generator=dropout_seeds)))
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()}, dropout_seeds.get_state()


def _assert_same_step(got, ref):
    (loss, grads, state), (ref_loss, ref_grads, ref_state) = got, ref
    assert loss == ref_loss
    assert set(grads) == set(ref_grads)
    g_max = max(g.abs().max().item() for g in ref_grads.values())
    for name, g in ref_grads.items():
        assert (grads[name] - g).abs().max().item() <= 1e-6 * g_max, name
    assert torch.equal(state, ref_state)  # the seeds were drawn once, not again in the recompute


@pytest.fixture(scope="module", params=[{}, dict(resblock_updown=True), dict(conv_resample=False)],
                ids=["conv_resample", "resblock_updown", "pool_resample"])
def plain_reference(request):
    kw = dict(PLAIN, **request.param)
    return kw, _step(False, kw)


@pytest.mark.parametrize("mode", MODES, ids=str)
def test_remat_step_equals_the_stored_step(plain_reference, mode):
    kw, ref = plain_reference
    _assert_same_step(_step(mode, kw), ref)


@pytest.fixture(scope="module")
def fused_reference():
    return _step(False, FUSED, "bfloat16", fused=True)


@pytest.mark.parametrize("mode", ["block", "level", "level:1"])
def test_fused_remat_step_equals_the_stored_step(fused_reference, mode, monkeypatch):
    """bf16, ``fused_conv=True``: 8 of the 10 ResBlocks run ``norm_act_conv``
    (the down and up ResBlocks are gated off). The recompute runs K2 again
    for every fused block inside a region."""
    from stain2stain_tpu_torch.ops import conv

    launches = [0]
    real = conv.fused_conv3x3

    def counting(*args, **kwargs):
        launches[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(conv, "fused_conv3x3", counting)
    got = _step(mode, FUSED, "bfloat16", fused=True)
    _assert_same_step(got, fused_reference)
    # 16 fused convs a forward; the recompute: all of them under "level", the
    # shallowest level's 3 blocks (6 convs) under "level:1" (the mid block and
    # level 1 are stored)
    assert launches[0] == 16 + {"block": 16, "level": 16, "level:1": 6}[mode]


def _saved_bytes(use_checkpoint, train: bool = True, grad: bool = True) -> int:
    torch.manual_seed(0)
    net = UNetModel(dim=(3, SIZE, SIZE), device="cpu", use_checkpoint=use_checkpoint, **PLAIN).train(train)
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), torch.set_grad_enabled(grad):
        net(torch.tensor([0.3, 0.7]), torch.randn(2, SIZE, SIZE, 3))
    return total[0]


def test_remat_regions_store_less_and_only_in_training():
    stored = _saved_bytes(False)
    # parameters are saved as well, so the ratio is not the activations' alone
    assert _saved_bytes("level") < 0.2 * stored
    assert _saved_bytes("block") < 0.3 * stored
    assert _saved_bytes("level") < _saved_bytes("level:1") < stored
    # eval mode (or no grad): the stored graph, as in JAX where remat is transparent
    assert _saved_bytes("level", train=False) == _saved_bytes(False, train=False)
    assert _saved_bytes("level", grad=False) == 0


@pytest.mark.parametrize(
    "value, want",
    [(False, (None, None)), (None, (None, None)), (True, ("block", None)), ("block", ("block", None)),
     ("level", ("level", None)), ("block:2", ("block", 2)), ("level:1", ("level", 1))],
    ids=str,
)
def test_remat_mode_values(value, want):
    assert remat_mode(value) == want


@pytest.mark.parametrize("value", ["blocks", "levels:2", "stage"])
def test_remat_mode_refuses_unknown_values(value):
    with pytest.raises(ValueError, match="use_checkpoint must be"):
        UNetModel(dim=(3, SIZE, SIZE), device="cpu", use_checkpoint=value, **PLAIN)


def test_level_remat_matches_jax():
    """``use_checkpoint="level"`` on both sides (dropout 0), converted weights:
    one CFM loss and its gradients."""
    kw = dict(PLAIN, num_channels=16)
    jnet = JaxUNet(dim=(3, SIZE, SIZE), fused_attention=False, dtype=jnp.float32, dropout=0.0,
                   use_checkpoint="level", **kw)
    rng = np.random.default_rng(3)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.zeros((2,), jnp.float32), jnp.zeros((2, SIZE, SIZE, 3)))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params["params"]
    )
    src, tgt = (rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    t = np.array([0.3, 0.75], np.float32)

    def loss_fn(p):
        matcher = JaxFlowMatcher(sigma=0.0)
        xt = matcher.sample_xt(None, jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(t))
        vt = jnet.apply({"params": p}, jnp.asarray(t), xt, train=True)
        return j_mse_loss(vt, matcher.conditional_flow(jnp.asarray(src), jnp.asarray(tgt), t))

    with jax.default_matmul_precision("highest"):
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    conv_kw = dict(image_size=SIZE, **kw)
    tnet = UNetModel(dim=(3, SIZE, SIZE), device="cpu", dropout=0.0, use_checkpoint="level", **kw).train()
    tnet.load_state_dict(unet_state_dict_from_flax(params, **conv_kw), strict=True)
    tt = torch.from_numpy(t)[:, None, None, None]
    x0, x1 = torch.from_numpy(src), torch.from_numpy(tgt)
    loss = torch.mean(torch.square(tnet(torch.from_numpy(t), tt * x1 + (1 - tt) * x0) - (x1 - x0)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=TOL, rtol=TOL)
    ref_sd = unet_state_dict_from_flax(jax.device_get(ref_grads), **conv_kw)
    for name, p in tnet.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_sd[name].numpy(), atol=TOL, rtol=TOL, err_msg=name)

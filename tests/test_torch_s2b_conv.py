"""PyTorch port's space-to-batch 3×3 conv vs ``F.conv2d`` and vs the JAX package's.

Mirrors ``tests/test_s2b_conv.py``: the forward against the padding=1 conv
it replaces and against JAX ``space_to_batch_conv`` (1e-5) over tile
factors, ragged channel counts and non-square grids; the gradients; bf16;
``UNetModel(s2b_conv=2)`` against JAX's UNet with the same knob and the
same weights (3e-4) and against the plain port UNet; the gate of JAX
``_s2b_factor``; the rejected shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu.ops.s2b_conv import space_to_batch_conv as jax_s2b
from stain2stain_tpu_torch.compat import unet_state_dict_from_flax
from stain2stain_tpu_torch.models import UNetModel
from stain2stain_tpu_torch.ops.s2b_conv import space_to_batch_conv

TOL = 1e-5
NET_TOL = 3e-4


def _inputs(shape, seed: int = 0):
    b, h, w, c, d = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    wt = (0.1 * rng.standard_normal((d, c, 3, 3))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(wt)


@pytest.mark.parametrize(
    "shape,factor",
    [((2, 16, 16, 8, 12), 2), ((1, 32, 16, 4, 4), 4), ((3, 8, 8, 5, 7), 2), ((4, 64, 64, 3, 6), 8),
     ((2, 24, 40, 6, 5), 2)],
)
def test_forward_matches_same_padding_conv_and_jax(shape, factor):
    x, w = _inputs(shape)
    got = space_to_batch_conv(x, w, factor)
    torch.testing.assert_close(got, F.conv2d(x, w, padding=1), atol=TOL, rtol=0)
    ref = jax_s2b(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
                  factor=factor, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_gradients_match():
    x, w = _inputs((2, 16, 16, 8, 8), seed=1)
    grads = []
    for conv in (lambda a, b: F.conv2d(a, b, padding=1), lambda a, b: space_to_batch_conv(a, b, 2)):
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        torch.sin(conv(xa, wa)).sum().backward()
        grads.append((xa.grad, wa.grad))
    (gx_ref, gw_ref), (gx, gw) = grads
    torch.testing.assert_close(gx, gx_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(gw, gw_ref, atol=1e-4, rtol=0)


def test_bf16_matches_bf16_reference():
    x, w = _inputs((2, 32, 32, 16, 16), seed=2)
    x = x.to(torch.bfloat16)
    got = space_to_batch_conv(x, w, 2)
    assert got.dtype == torch.bfloat16
    ref = F.conv2d(x, w.to(torch.bfloat16), padding=1)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-1, rtol=0)


NET = dict(num_channels=32, num_res_blocks=1, channel_mult=(1, 2), attention_resolutions="16", num_head_channels=16)


def test_unet_s2b_matches_jax_and_plain_unet():
    """``s2b_conv=2`` at 64 px: the levels at 64² and 32² tile (tiles of 32 and
    16 px); the port's net against JAX's with the same knob and weights, and
    against the port's plain-conv net (same state-dict keys)."""
    size = 64
    jnet = JaxUNet(dim=(3, size, size), s2b_conv=2, fused_attention=False, dtype=jnp.float32, **NET)
    x = np.random.default_rng(3).standard_normal((2, size, size, 3)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    params = jax.jit(jnet.init)(jax.random.key(0), jnp.asarray(t), jnp.asarray(x))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
                                    params)
    sd = unet_state_dict_from_flax(params, image_size=size, **NET)
    net = UNetModel(dim=(3, size, size), s2b_conv=2, device="cpu", **NET).eval()
    plain = UNetModel(dim=(3, size, size), device="cpu", **NET).eval()
    net.load_state_dict(sd, strict=True)
    plain.load_state_dict(sd, strict=True)
    tiled = [m for m in net.modules() if hasattr(m, "_s2b_factor") and m.s2b_conv == 2]
    assert tiled and set(net.state_dict()) == set(plain.state_dict())
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jnet.apply({"params": params}, jnp.asarray(t), jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(t), torch.from_numpy(x)).numpy()
        unfused = plain(torch.from_numpy(t), torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() < NET_TOL * scale
    assert np.abs(got - unfused).max() < 1e-5 * scale


def test_s2b_factor_gate():
    """JAX's gate: no up/down blocks, f must divide H and W, tiles ≥ 16 px."""
    net = UNetModel(dim=(3, 64, 64), s2b_conv=2, resblock_updown=True, device="cpu", **NET)
    blocks = [m for m in net.modules() if hasattr(m, "_s2b_factor")]
    plain = next(b for b in blocks if not (b.up or b.down))
    assert plain._s2b_factor(torch.zeros(1, 32, 64, 64)) == 2
    assert plain._s2b_factor(torch.zeros(1, 32, 32, 32)) == 2
    assert plain._s2b_factor(torch.zeros(1, 32, 30, 30)) == 0  # 15-px tiles
    assert plain._s2b_factor(torch.zeros(1, 32, 33, 64)) == 0  # not divisible
    assert all(b._s2b_factor(torch.zeros(1, 32, 64, 64)) == 0 for b in blocks if b.up or b.down)
    assert UNetModel(dim=(3, 16, 16), device="cpu", **NET).input_blocks[1][0]._s2b_factor(
        torch.zeros(1, 32, 64, 64)) == 0


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="not divisible"):
        space_to_batch_conv(torch.zeros(1, 4, 10, 10), torch.zeros(4, 4, 3, 3), factor=4)
    with pytest.raises(ValueError, match="specialised to 3x3"):
        space_to_batch_conv(torch.zeros(1, 4, 8, 8), torch.zeros(4, 4, 5, 5), factor=2)

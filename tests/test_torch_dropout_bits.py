"""The port's ``hardware_dropout`` (``FastDropout(impl="bits")``) against the
JAX package's, on the CPU.

torch's generator is not JAX's PRNG, so the masks of one seed differ (a
planned difference). What can match does:

- the keep rule: over all 2^16 words, the kept set (and so the integer
  threshold) equals JAX ``_mask``'s for several rates, bit for bit, with
  both generators replaced by the same words;
- values in {0, 1/(1-rate)}, a keep fraction within 5σ of 1 - rate;
- a backward that regenerates the forward's mask from the seed (nothing
  else is saved), as JAX's ``custom_vjp`` does;
- the same mask for the same generator state, another for another;
- a small model with bits dropout trains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.ops import dropout as jdropout
from stain2stain_tpu_torch.ops import dropout as tdropout

SPAN = 1 << 16


@pytest.mark.parametrize("rate", [1e-6, 0.1, 0.25, 0.5, 0.9, 1 - 1e-6])
def test_keep_rule_matches_jax(rate, monkeypatch):
    """Every 16-bit word once, through both masks: JAX's words 0 … 2^16-1 and
    the port's the same words as int16 (w − 2^15)."""
    monkeypatch.setattr(jax.random, "bits", lambda key, shape, dtype: jnp.arange(SPAN, dtype=dtype).reshape(shape))
    ref = np.asarray(jdropout._mask(jax.random.key(0), (SPAN,), rate, jnp.float32, 16))

    def words(low, high, shape, dtype, device, generator):
        return torch.arange(low, high, dtype=torch.int32).to(dtype).reshape(shape)

    monkeypatch.setattr(torch, "randint", words)
    got = tdropout.bits_mask(0, (SPAN,), rate, torch.float32)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int((got != 0).sum()) == tdropout.bits_threshold(rate) == min(SPAN - 1, round((1 - rate) * SPAN))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_values_keep_fraction_and_regenerated_backward(rate):
    x = torch.randn(4, 8, 32, 32, generator=torch.Generator().manual_seed(1)).requires_grad_()
    y = tdropout.hardware_dropout(x, seed=12345, rate=rate)
    assert y.grad_fn.saved_tensors == ()  # no mask kept for the backward
    y.backward(torch.ones_like(y))
    mask = x.grad  # dy = 1: the backward's mask itself
    scale = torch.tensor(1.0 / (1.0 - rate))
    assert set(torch.unique(mask).tolist()) == {0.0, scale.item()}
    torch.testing.assert_close(y, x.detach() * mask, rtol=0, atol=0)  # the forward's mask is the backward's
    torch.testing.assert_close(mask, tdropout.bits_mask(12345, x.shape, rate, x.dtype), rtol=0, atol=0)
    n = mask.numel()
    kept = float((mask != 0).float().mean())
    assert abs(kept - (1 - rate)) <= 5 * np.sqrt(rate * (1 - rate) / n)


def test_fast_dropout_bits_is_deterministic_per_generator_state():
    drop = tdropout.FastDropout(0.3, impl="bits").train()
    x = torch.ones(2, 3, 16, 16, dtype=torch.bfloat16)
    a = drop(x, torch.Generator().manual_seed(5))
    b = drop(x, torch.Generator().manual_seed(5))
    c = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.bfloat16
    assert set(torch.unique(a.float()).tolist()) == {0.0, torch.tensor(1 / 0.7, dtype=torch.bfloat16).item()}
    assert torch.equal(drop(x, seed=77), drop(x, seed=77))  # a seed drawn ahead, as the UNet's remat draws it
    drop.eval()
    assert drop(x) is x
    # the hash impl on the same seed draws another mask
    assert not torch.equal(drop.train()(x, seed=77), tdropout.FastDropout(0.3).train()(x, seed=77))


def test_a_model_with_bits_dropout_trains():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 16, generator=gen)
    y = x @ torch.randn(16, 1, generator=gen)
    model = torch.nn.Sequential(torch.nn.Linear(16, 64), tdropout.FastDropout(0.1, impl="bits"), torch.nn.Linear(64, 1))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for step in range(30):
        h = model[1](model[0](x), torch.Generator().manual_seed(step))
        loss = torch.nn.functional.mse_loss(model[2](h), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]

"""The hash dropout kernel (``csrc/dropout.cu``) on the card, against the
plain ``x * hash_mask(...)``, bit for bit. Marked ``chip``: it skips without a
card. The file imports neither JAX nor the JAX package, so it runs on the
card: ``python -m pytest --noconftest tests/test_torch_dropout_kernel.py -m chip -q``."""

from __future__ import annotations

import pytest
import torch

from chip_smoke import same_bits
from stain2stain_tpu_torch import ops
from stain2stain_tpu_torch.ops import dropout as tdropout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (2, 6, 5, 7)])
def test_kernel_is_the_plain_product_bit_for_bit(card, dtype, shape):
    """Forward and gradient, vectors (16 × 16 planes) and scalars (5 × 7), a
    transposed view too; one launch a call."""
    gen = torch.Generator(device=card).manual_seed(0)
    base = torch.randn(shape, device=card, generator=gen)
    base.view(-1)[:4] = torch.tensor([-0.0, float("inf"), float("nan"), 0.0])
    for x in (base, base.transpose(2, 3)):
        x = x.to(dtype).detach().requires_grad_()
        dy = torch.randn(x.shape, device=card, generator=gen).to(dtype)
        for seed, rate in ((0, 0.1), (2**32 - 1, 0.5)):
            ops.zero_launches()
            y = tdropout.hash_dropout(x, seed, rate)
            (dx,) = torch.autograd.grad(y, x, dy)
            assert ops.launches()["dropout"] == 2
            mask = tdropout.hash_mask(seed, tuple(x.shape), rate, dtype, card)
            assert same_bits(y, x.detach() * mask) and same_bits(dx, dy * mask)


@pytest.mark.chip
def test_kernel_refuses_other_dtypes(card):
    """A CUDA tensor of a dtype the kernel does not take raises; it is not
    sent to the plain product."""
    x = torch.ones(2, 6, 5, 7, dtype=torch.float64, device=card)
    ops.zero_launches()
    with pytest.raises(TypeError, match="float64"):
        tdropout.hash_dropout(x, 12345, 0.1)
    assert ops.launches()["dropout"] == 0

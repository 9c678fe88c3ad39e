"""K1 at head dim 72 (DiT-XL/2's heads; bfloat16 alone) on the card, against
the plain versions, bit for bit from run to run, and on its own route (the
wgmma kernels of ``csrc/attention_d72.cuh``; d 64 stays on the mma.sync
kernels); and K1 at head dims 32 and 64 against digests of what the kernels
gave before d 72 came in. Marked ``chip``: it skips without a card.
The file imports neither JAX nor the JAX package, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_attention_d72.py -m chip -q``."""

from __future__ import annotations

import hashlib
import math

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from chip_smoke import BWD_REL_TOL, LSE_TOL, TOL
from stain2stain_tpu_torch import ops
from stain2stain_tpu_torch.models import DiT
from stain2stain_tpu_torch.ops import attention as tattn

# The digests (sha256 of the bytes of o, lse, dq, dk, dv, first 16 hex digits)
# that the kernels built from the sources before head dim 72 was added gave on
# the inputs of _inputs, on an H100 (torch 2.11, CUDA 12.8): the shared
# templates' change has to leave d 32 and 64 bit for bit what they were.
PARENT_DIGESTS = {"32-bfloat16": "e1ba488c31d3724b", "32-float32": "59cd0b1d99d29060",
                  "64-bfloat16": "8022bfffcce2de23", "64-float32": "66252836bc9f70cf"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(bh: int, t: int, d: int, dtype, card, seed: int = 0, q_scale: float = 1.0):
    """q, k, v, do from numpy's generator (the same bits on every machine). Peaked
    logits (q × q_scale) come with v ÷ q_scale, as in ``chip_smoke.py``: the near
    one-hot outputs keep the unit range the absolute bf16 tolerance is set for."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, d), dtype=np.float32)) for _ in range(4))
    return [x.to(card).to(dtype) for x in (q * q_scale, k, v / q_scale, do)]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def run_k1(q, k, v, do):
    """K1-fwd with the lse, then K1-bwd with it, as training calls them."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = tattn.fused_attention(q, k, v, scale, return_lse=True)
    return (o, lse, *tattn.fused_attention_backward(q, k, v, o, do, scale, lse))


@pytest.mark.chip
@pytest.mark.parametrize("bh,t,q_scale", [(512, 1024, 1.0), (48, 1000, 1.0), (64, 1024, 8.0), (1, 300, 1.0)],
                         ids=["dit-512px", "ragged", "peaked", "one-slice-ragged-tiles"])
def test_k1_at_72_is_the_plain_attention(card, bh, t, q_scale):
    """Forward, lse and backward at DiT-XL/2's training shape (batch 32 × 16
    heads, T 1024), a ragged T, peaked logits, and one slice whose T (300) is
    a multiple of neither the route's 128-row blocks nor its 64-row streamed
    tiles (its last block's second box lies wholly past T). Tolerances are chip_smoke's:
    the outputs are rounded to bf16 (an ulp is 2^-8 of a value under 1), p is
    rounded to bf16 as an operand of p·v and ds of the gradient products, so
    the forward is held to 8e-3 absolute, the lse (f32, the logits' order of
    sums alone) to 1e-4, and dq, dk, dv to 1 % of their largest magnitude."""
    q, k, v, do = _inputs(bh, t, 72, torch.bfloat16, card, seed=bh + t, q_scale=q_scale)
    scale = 1.0 / math.sqrt(72)
    ops.zero_launches()
    o, lse, dq, dk, dv = run_k1(q, k, v, do)
    again = run_k1(q, k, v, do)
    torch.cuda.synchronize()
    assert (ops.launches()["K1-fwd"], ops.launches()["K1-bwd"]) == (2, 2)
    ref, ref_lse = tattn.fused_attention_reference(q, k, v, scale, return_lse=True)
    assert (o.float() - ref.float()).abs().max().item() <= TOL["bfloat16"]
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    grads = tattn.fused_attention_backward_reference(q, k, v, o, do, scale)
    ref_max = max(g.float().abs().max().item() for g in grads)
    for got, want in zip((dq, dk, dv), grads):
        assert torch.isfinite(got).all()
        assert (got.float() - want.float()).abs().max().item() <= BWD_REL_TOL["bfloat16"] * ref_max
    assert all(torch.equal(a, b) for a, b in zip((o, lse, dq, dk, dv), again))  # deterministic, no atomics


@pytest.mark.chip
def test_k1_at_72_repeats_bit_for_bit(card):
    """Two forward + backward calls at the DiT's training shape give one digest:
    every gradient is summed in a fixed order and written once, no atomics."""
    inputs = _inputs(512, 1024, 72, torch.bfloat16, card, seed=3)
    assert digest(run_k1(*inputs)) == digest(run_k1(*inputs))


def _attention_kernels(d: int, card) -> list[str]:
    """The names of the attention kernels a bf16 forward + backward at head dim d launches."""
    q, k, v, do = _inputs(8, 256, d, torch.bfloat16, card, seed=d)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_k1(q, k, v, do)
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if "attention_" in e.key]


@pytest.mark.chip
def test_k1_takes_the_wgmma_route_at_72_alone(card):
    """d 72 launches the route's three kernels (forward, dk/dv, dq) and no
    mma.sync kernel at 72; d 64 still launches the mma.sync kernels and none
    of the route's."""
    at72, at64 = _attention_kernels(72, card), _attention_kernels(64, card)
    for name in ("attention_fwd_wgmma_kernel", "attention_bwd_dkdv_wgmma_kernel", "attention_bwd_dq_wgmma_kernel"):
        assert any(name in k for k in at72), at72
    assert not any("_mma_kernel<72>" in k for k in at72), at72
    for name in ("attention_fwd_mma_kernel<64>", "attention_bwd_dkdv_mma_kernel<64>", "attention_bwd_dq_mma_kernel<64>"):
        assert any(name in k for k in at64), at64
    assert not any("wgmma" in k for k in at64), at64


@pytest.mark.chip
def test_k1_refuses_f32_at_72(card):
    x = torch.zeros(4, 64, 72, device=card)
    ops.zero_launches()
    with pytest.raises(ValueError, match="bfloat16 only"):
        tattn.fused_attention(x, x, x, 1.0)
    assert ops.launches()["K1-fwd"] == 0


@pytest.mark.chip
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k1_at_32_and_64_gives_what_it_gave_before(card, d, dtype):
    key = f"{d}-{str(dtype).split('.')[-1]}"
    assert digest(run_k1(*_inputs(48, 1000, d, dtype, card, seed=d))) == PARENT_DIGESTS[key]


@pytest.mark.chip
def test_a_bf16_dit_goes_through_k1(card):
    """A small DiT with heads of 72, bf16 compute: one K1-fwd and one K1-bwd a
    block, every gradient finite; nothing goes elsewhere."""
    net = DiT(dim=[3, 32, 32], patch_size=8, hidden_size=144, depth=2, num_heads=2, device=card)
    net.dtype = torch.bfloat16
    with torch.no_grad():
        for block in net.blocks:  # off DiT's zero init, so the blocks do work
            block.adaLN_modulation[1].weight.normal_(std=0.02)
        net.final_layer.linear.weight.normal_(std=0.02)
    x = torch.randn(4, 32, 32, 3, device=card)
    ops.zero_launches()
    net(torch.rand(4, device=card), x).square().mean().backward()
    torch.cuda.synchronize()
    assert (ops.launches()["K1-fwd"], ops.launches()["K1-bwd"]) == (2, 2)
    assert all(torch.isfinite(p.grad).all() for p in net.parameters())

"""The DiT velocity net of the port (``models/dit.py``) against the
benchmark's plain reference (``benchmark/reference/dit.py``) on the CPU, at a
small size (depth 2, hidden 144 = 2 heads of 72, 32-px tiles in 8-px patches:
T 16); its LayerNorm-modulate op (the plain chain on CPU tensors, the checks
and counters of its card kernels); the published net's size on ``meta``; K1's
check at head dim 72."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import inputs, work
from benchmark.core import reference
from benchmark.tests.tiny import ROOT
from stain2stain_tpu_torch import _build, ops
from stain2stain_tpu_torch.models import DiT
from stain2stain_tpu_torch.ops import attention as tattn
from stain2stain_tpu_torch.ops import norms
from stain2stain_tpu_torch.ops.norms import layer_norm_modulate
from stain2stain_tpu_torch.utils import tracing

SMALL = {"dim": [3, 32, 32], "patch_size": 8, "hidden_size": 144, "depth": 2, "num_heads": 2, "mlp_ratio": 4.0}
PUBLISHED = {"dim": [3, 512, 512], "patch_size": 16, "hidden_size": 1152, "depth": 28, "num_heads": 16,
             "mlp_ratio": 4.0}
# f32 on the CPU on both sides: the two differ only in the order of sums (the
# patch embedding a dense layer against a conv, the LayerNorm's statistics)
REL_TOL = 2e-5


def _ref():
    return reference(ROOT, "benchmark/reference/dit.py")


def _pair(seed: int):
    """The port's small DiT and the reference's, with the benchmark's weights of ``seed``."""
    ref = _ref()
    net = DiT(**SMALL, device="cpu")
    refnet = ref.build(SMALL, device="cpu")
    names_shapes = [(k, tuple(p.shape)) for k, p in net.named_parameters()]
    assert sorted(names_shapes) == sorted((k, tuple(p.shape)) for k, p in refnet.named_parameters())
    weights = inputs.make_weights(names_shapes, seed, "cpu", ref.zeroed)
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(weights[k])
    refnet.load_state_dict(weights)
    return net, refnet


def _close(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    assert scale > 0 and err <= REL_TOL * scale, f"{what}: max |diff| {err} against max |ref| {scale}"


def test_velocity_and_cfm_gradients_equal_the_reference():
    net, refnet = _pair(2**31 + 17)
    rng = np.random.default_rng(3)
    x0, x1 = (torch.from_numpy(rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)) for _ in range(2))
    t = torch.from_numpy(rng.random(4).astype(np.float32))
    xt = (1 - t[:, None, None, None]) * x0 + t[:, None, None, None] * x1
    v = net(t, xt)
    v_ref = refnet(t, xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(v, v_ref, "velocity")
    assert v.abs().max() > 0.1  # the drawn weights give every layer work
    grads = []
    for model, out in ((net, v), (refnet, v_ref)):
        loss = torch.mean((out - (x1 - x0)) ** 2)
        grads.append(dict(zip([k for k, _ in model.named_parameters()],
                              torch.autograd.grad(loss, list(model.parameters())))))
    for k, g in grads[0].items():
        _close(g, grads[1][k], f"gradient of {k}")


def test_dit_initialization_makes_every_block_the_identity_and_the_velocity_zero():
    torch.manual_seed(0)
    net = DiT(**SMALL, device="cpu")
    x = torch.randn(2, 32, 32, 3)
    t = torch.tensor([0.25, 0.75])
    tokens = torch.randn(2, 16, 144)
    c_silu = torch.nn.functional.silu(net.t_embedder(t, torch.float32))
    for block in net.blocks:
        assert torch.equal(block(tokens, c_silu, torch.float32), tokens)
    assert torch.count_nonzero(net(t, x)) == 0
    # and the rest drawn as DiT draws it: nonzero kernels, zero biases
    assert net.blocks[0].attn.qkv.weight.abs().max() > 0 and torch.count_nonzero(net.blocks[0].attn.qkv.bias) == 0
    assert abs(net.t_embedder.mlp[0].weight.std().item() - 0.02) < 0.002


def _dit_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """DiT's ``get_2d_sincos_pos_embed`` as ``models.py`` writes it."""

    def one_d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64)
        omega /= dim / 2.0
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(grid_size, dtype=np.float32), np.arange(grid_size, dtype=np.float32))
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    return np.concatenate([one_d(embed_dim // 2, grid[0]), one_d(embed_dim // 2, grid[1])], axis=1)


@pytest.mark.parametrize("hidden,grid", [(144, 4), (1152, 32)], ids=["small", "published"])
def test_pos_embed_is_dits_sincos_formula_and_a_buffer(hidden, grid):
    net = DiT(dim=[3, 8 * grid, 8 * grid], patch_size=8, hidden_size=hidden, depth=1,
              num_heads=hidden // 72, device="meta")
    assert "pos_embed" not in dict(net.named_parameters()) and "pos_embed" not in net.state_dict()
    from stain2stain_tpu_torch.models.dit import sincos_pos_embed

    want = torch.from_numpy(_dit_pos_embed(hidden, grid)).float()
    assert torch.allclose(sincos_pos_embed(hidden, grid), want, rtol=0, atol=1e-6)


def test_published_net_has_dits_size_and_shapes():
    net = DiT(**PUBLISHED, device="meta")
    assert sum(p.numel() for p in net.parameters()) == 675_396_480
    ref = _ref()
    assert ref.attention_shapes(PUBLISHED, 512) == [(16, 1024, 72)] * 28
    assert sum(p.numel() for p in ref.build(PUBLISHED, device="meta").parameters()) == 675_396_480
    flops = work.forward_flops(ref, PUBLISHED, 512)
    attn = sum(work.attention_work(h, t, d, "bfloat16", False)[0] for h, t, d in ref.attention_shapes(PUBLISHED, 512))
    assert 1.04e12 < flops < 1.06e12 and 0.12 < attn / flops < 0.14  # about 1.05 TFLOP a tile, 12.9 % attention


def test_forward_spans_under_a_traced_step():
    net = DiT(**SMALL, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.root("train.step"):
            with tracing.span("train.forward_backward"):
                net(torch.tensor(0.5), torch.zeros(2, 32, 32, 3))
    spans = {s.name: s for s in tracing.spans()}
    assert {"dit.embed", "dit.blocks", "dit.final"} <= set(spans)
    assert spans["dit.blocks"].attrs == {"blocks": 2, "tokens": 16}
    assert spans["dit.blocks"].parent == spans["train.forward_backward"].id


def test_layer_norm_modulate_is_the_plain_chain_and_its_backward_checks():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 24, generator=g) * 3 + 1
    scale, shift = torch.randn(3, 24, generator=g), torch.randn(3, 24, generator=g)
    plain = torch.nn.functional.layer_norm(x, (24,), eps=1e-6) * (1 + scale[:, None]) + shift[:, None]
    assert torch.allclose(layer_norm_modulate(x, scale, shift), plain, rtol=0, atol=2e-6)
    assert layer_norm_modulate(x, scale, shift, dtype=torch.bfloat16).dtype == torch.bfloat16
    args = [a.double().requires_grad_() for a in (x[:, :3, :8], scale[:, :8], shift[:, :8])]
    assert torch.autograd.gradcheck(lambda *a: layer_norm_modulate(*a), args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_layer_norm_modulate_keeps_the_plain_chain_on_cpu_tensors(dtype):
    """CPU tensors of any float dtype take ``_LayerNormModulate`` both ways, bit
    for bit, and never count a launch of the card's kernels."""
    ops.zero_launches()
    g = torch.Generator().manual_seed(2)
    leaves = [(torch.randn(*shape, generator=g) * 3 + 1).to(dtype).requires_grad_() for shape in
              ((2, 5, 16), (2, 16), (2, 16))]
    dy = torch.randn(2, 5, 16, generator=g).to(dtype)
    y = layer_norm_modulate(*leaves)
    plain = norms._LayerNormModulate.apply(*leaves, 1e-6, dtype)
    assert torch.equal(y, plain)
    for a, b in zip(torch.autograd.grad(y, leaves, dy), torch.autograd.grad(plain, leaves, dy)):
        assert torch.equal(a, b)
    assert ops.launches()["ln_modulate_fwd"] == 0 and ops.launches()["ln_modulate_bwd"] == 0


@pytest.mark.parametrize("x_shape,x_dtype,p_dtypes,match", [
    ((2, 4, 20), torch.float32, (torch.float32, torch.float32), "multiple of 8"),
    ((2, 4, 1160), torch.float32, (torch.float32, torch.float32), "up to 1152"),
    ((2, 4, 16), torch.float64, (torch.float64, torch.float64), "float64"),
    ((2, 4, 16), torch.float32, (torch.float16, torch.float16), "float16"),
    ((2, 4, 16), torch.float32, (torch.float32, torch.bfloat16), "one dtype"),
    ((2, 16), torch.float32, (torch.float32, torch.float32), r"\(B, T, C\)"),
], ids=["c20", "c1160", "float64", "float16-params", "mixed-params", "2d"])
def test_ln_modulate_kernels_refuse_before_anything_builds(x_shape, x_dtype, p_dtypes, match):
    """The card's wrappers check shapes and dtypes first: what the kernels do
    not take raises a ``ValueError`` naming it, before nvcc or a launch."""
    x = torch.zeros(x_shape, dtype=x_dtype)
    scale, shift = (torch.zeros(2, x_shape[-1], dtype=dt) for dt in p_dtypes)
    with pytest.raises(ValueError, match=match):
        norms.ln_modulate_fwd(x, scale, shift, 1e-6, x_dtype)
    assert norms.ln_modulate_fwd.launches == 0


def test_ln_modulate_launch_counts_are_listed_and_reset():
    assert "layer_norm_modulate.cu" in _build.SOURCES
    norms.ln_modulate_fwd.launches, norms.ln_modulate_bwd.launches = 57, 57
    assert ops.launches()["ln_modulate_fwd"] == 57 and ops.launches()["ln_modulate_bwd"] == 57
    ops.zero_launches()
    assert norms.ln_modulate_fwd.launches == 0 and norms.ln_modulate_bwd.launches == 0


@pytest.mark.parametrize("dtype,d,ok", [(torch.bfloat16, 72, True), (torch.float32, 72, False),
                                        (torch.bfloat16, 40, False)], ids=["bf16-72", "f32-72", "bf16-40"])
def test_k1_check_takes_head_dim_72_in_bf16_alone(dtype, d, ok):
    x = torch.zeros(4, 10, d, dtype=dtype)
    if ok:
        tattn._check(x, x, x)
    else:
        with pytest.raises(ValueError, match="bfloat16 only" if d == 72 else "head dims"):
            tattn._check(x, x, x)


def test_attention_at_72_on_the_cpu_is_the_plain_softmax():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 16, 2, 72, generator=g) for _ in range(3))
    out = tattn.attention(q, k, v, 72)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(72)
    assert torch.allclose(out, torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v), atol=1e-6)

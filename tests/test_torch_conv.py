"""The port's fused 3×3 conv (``stain2stain_tpu_torch/ops/conv.py``) against the
JAX package's Pallas kernels (``stain2stain_tpu/ops/pallas_conv.py``).

On the CPU every wrapper runs its plain version; the JAX side runs its Pallas
kernels in interpret mode, as ``tests/test_pallas_conv.py`` does. Inputs are
made with numpy from a seed and handed to both. Parity with JAX is checked at
dropout rate 0 (the TPU kernels' masks come from the TPU's hardware PRNG);
the port's dropout is checked against itself and against ``hash_mask``.

Tolerances, as multiples of max(|ref|, 1) per element:
- bf16 outputs (K2, K3, K4's dx), bf16 against bf16: 2e-2 relative + 2e-2
  absolute — both sides round n and y to bf16 at the same points; the f32 sums
  run in another order, which can move a rounding by one bf16 ulp (2^-7);
- f32 sums over bf16 products (dscale, dshift, dW, dbias): 1e-3 relative +
  1e-3 absolute — the same bf16 inputs, f32 accumulation in another order;
- ``gn_stats`` and ``fold_norm_affine`` (f32 only): 1e-5;
- ``norm_act_conv`` value and gradients: the budgets of
  ``tests/test_pallas_conv.py::test_norm_act_conv_value_and_grads`` (0.06/0.03
  value, 0.1/0.08 gradients), since both sides round x̂ and n to bf16.
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.ops import pallas_conv as pc
from stain2stain_tpu_torch import _build
from stain2stain_tpu_torch.ops import conv
from stain2stain_tpu_torch.ops.dropout import hash_mask

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SUM_TOL = dict(rtol=1e-3, atol=1e-3)
SHAPES = [(2, 32, 16, 128, 128), (2, 16, 32, 128, 256), (2, 8, 16, 128, 128)]
# H 20: past the last whole 8- or 16-row tile of the kernels; C 384: the
# flagship's level-0 skip-concat width
RAGGED = (2, 20, 16, 384, 128)
# the fused flagship's (H·W, C, D) at 256 px (``test_supported_on_flagship_shapes_and_refused_ones``)
FLAGSHIP = [
    (65536, 128, 128), (65536, 256, 128), (65536, 384, 128),
    (16384, 128, 256), (16384, 256, 256), (16384, 512, 256),
    (4096, 256, 256), (4096, 512, 256), (4096, 768, 256),
    (1024, 256, 512), (1024, 512, 512), (1024, 1024, 512),
]


def _flagship_k4_shapes():
    """(H·W, C) of each of the 44 K4 launches of one fused flagship backward at
    256 px: the input of both convs of each of the 22 ResBlocks of ADM's UNet
    with 128 channels, mult (1, 2, 2, 4) and 2 res-blocks a level (8 down, 2
    in the middle, 12 up, the up blocks' inputs widened by the skip concat)."""
    mult, blocks, base, side = (1, 2, 2, 4), 2, 128, 256
    shapes, skips, ch = [], [base], base
    for level, m in enumerate(mult):
        hw = (side >> level) ** 2
        for _ in range(blocks):
            shapes += [(hw, ch), (hw, base * m)]
            ch = base * m
            skips.append(ch)
        if level < len(mult) - 1:
            skips.append(ch)  # the downsampler's output
    shapes += [((side >> 3) ** 2, ch)] * 4  # the middle's two ResBlocks
    for level, m in reversed(list(enumerate(mult))):
        hw = (side >> level) ** 2
        for _ in range(blocks + 1):
            shapes += [(hw, ch + skips.pop()), (hw, base * m)]
            ch = base * m
    return shapes


FLAGSHIP_K4 = _flagship_k4_shapes()


def _close(got, want, rtol, atol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    denom = np.maximum(np.abs(want), 1.0)
    np.testing.assert_allclose(got / denom, want / denom, rtol=rtol, atol=atol)


def _inputs(B=2, H=32, W=16, C=128, D=128, seed=0):
    """bf16-representable numpy inputs (f32 arrays) of the fused conv."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    return dict(
        x=bf16(rng.standard_normal((B, H, W, C))),
        w=bf16(rng.standard_normal((3, 3, C, D)) * 0.08),
        bias=(rng.standard_normal(D) * 0.1).astype(np.float32),
        scale=(1.0 + 0.2 * rng.standard_normal((B, C))).astype(np.float32),
        shift=(0.2 * rng.standard_normal((B, C))).astype(np.float32),
        dy=bf16(rng.standard_normal((B, H, W, D))),
    )


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


@pytest.mark.parametrize("B,H,W,C,D", SHAPES)
def test_fused_conv_plain_matches_jax(B, H, W, C, D):
    d = _inputs(B, H, W, C, D)
    want = pc.fused_conv3x3(_j(d["x"], jnp.bfloat16), _j(d["w"], jnp.bfloat16), _j(d["bias"]), interpret=True)
    got = conv.fused_conv3x3(_t(d["x"], torch.bfloat16), _t(d["w"]), _t(d["bias"]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, W, D)
    _close(got.float(), want, **BF16_TOL)


@pytest.mark.parametrize("shift_offset", [0.0, 2.0], ids=["affine_silu", "halo_rows_shift_plus_2"])
def test_fused_conv_affine_silu_matches_jax(shift_offset):
    """With shift + 2, silu(shift) ≈ 1.76: an edge row padded before the
    prologue instead of after it would show at once (``test_pallas_conv.py:88``)."""
    d = _inputs()
    shift = d["shift"] + shift_offset
    want = pc.fused_conv3x3(
        _j(d["x"], jnp.bfloat16), _j(d["w"], jnp.bfloat16), _j(d["bias"]),
        scale=_j(d["scale"]), shift=_j(shift), act="silu", interpret=True,
    )
    got = conv.fused_conv3x3(
        _t(d["x"], torch.bfloat16), _t(d["w"]), _t(d["bias"]),
        scale=_t(d["scale"]), shift=_t(shift), act="silu",
    ).float()
    want = np.asarray(want, np.float32)
    _close(got[:, :2], want[:, :2], **BF16_TOL)    # top edge
    _close(got[:, -2:], want[:, -2:], **BF16_TOL)  # bottom edge
    _close(got[:, :, :1], want[:, :, :1], **BF16_TOL)  # left edge
    _close(got, want, **BF16_TOL)


@pytest.mark.parametrize("B,H,W,C,D", SHAPES + [RAGGED])
def test_input_grad_matches_jax(B, H, W, C, D):
    d = _inputs(B, H, W, C, D)
    want = pc.conv3x3_input_grad(_j(d["dy"], jnp.bfloat16), _j(d["w"], jnp.bfloat16), interpret=True)
    got = conv.conv3x3_input_grad(_t(d["dy"], torch.bfloat16), _t(d["w"]))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, W, C)
    _close(got.float(), want, **BF16_TOL)


@pytest.mark.parametrize(
    "shape,affine",
    [((2, 32, 16, 128), True), ((2, 32, 16, 128), False), (RAGGED[:4], True), (RAGGED[:4], False)],
    ids=["affine_silu", "plain", "ragged_affine_silu", "ragged_plain"],
)
def test_prologue_grad_matches_jax(shape, affine):
    """At the ragged shape (H 20, C 384) too: 320 pixels an image, so K4's
    walk ends inside a 64-pixel step and C spans six 64-channel blocks."""
    B, H, W, C = shape
    d = _inputs(B, H, W, C, C)
    dn = _inputs(B, H, W, C, C, seed=1)["dy"]  # (B, H, W, C) bf16-representable
    kw_j = dict(scale=_j(d["scale"]), shift=_j(d["shift"]), act="silu") if affine else {}
    kw_t = dict(scale=_t(d["scale"]), shift=_t(d["shift"]), act="silu") if affine else {}
    want = pc.prologue_grad(_j(d["x"], jnp.bfloat16), _j(dn, jnp.bfloat16), interpret=True, **kw_j)
    got = conv.prologue_grad(_t(d["x"], torch.bfloat16), _t(dn, torch.bfloat16), **kw_t)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close(got[0].float(), want[0], **BF16_TOL)
    _close(got[1], want[1], **SUM_TOL)
    _close(got[2], want[2], **SUM_TOL)


@pytest.mark.parametrize("B,H,W,C,D", SHAPES + [RAGGED])
def test_weight_grad_matches_jax(B, H, W, C, D):
    """With the affine + SiLU prologue, and at the ragged shape without it: there
    the two sides' n would differ by one bf16 rounding of SiLU in a few of its
    245,760 elements, each moving a dW sum by far more than the f32 budget;
    without a prologue n = x on both sides and only the summation order differs."""
    d = _inputs(B, H, W, C, D)
    prologue = (B, H, W, C, D) != RAGGED
    kw_j = dict(scale=_j(d["scale"]), shift=_j(d["shift"]), act="silu") if prologue else {}
    kw_t = dict(scale=_t(d["scale"]), shift=_t(d["shift"]), act="silu") if prologue else {}
    want_dw, want_db = pc.conv3x3_weight_grad(
        _j(d["x"], jnp.bfloat16), _j(d["dy"], jnp.bfloat16), interpret=True, **kw_j
    )
    got_dw, got_db = conv.conv3x3_weight_grad(_t(d["x"], torch.bfloat16), _t(d["dy"], torch.bfloat16), **kw_t)
    assert tuple(got_dw.shape) == (3, 3, C, D) and got_dw.dtype == torch.float32
    _close(got_dw, want_dw, **SUM_TOL)
    _close(got_db, want_db, **SUM_TOL)


def test_norm_act_conv_value_and_grads_match_jax():
    """Value and all seven gradients through torch autograd against ``jax.vjp``."""
    B, H, W, C, D = 2, 32, 16, 128, 128
    rng = np.random.default_rng(5)
    d = _inputs(B, H, W, C, D, seed=5)
    args = dict(
        x=d["x"], w=d["w"], bias=d["bias"],
        gamma=(1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(C)).astype(np.float32),
        film_scale=(0.1 * rng.standard_normal((B, C))).astype(np.float32),
        film_shift=(0.1 * rng.standard_normal((B, C))).astype(np.float32),
    )
    cot = rng.standard_normal((B, H, W, D)).astype(np.float32)

    def fused_j(x, w, bias, gamma, beta, fs, ft):
        return pc.norm_act_conv(
            x, w, bias, gamma, beta, film_scale=fs, film_shift=ft, groups=32, act="silu", interpret=True,
        ).astype(jnp.float32)

    jargs = [_j(args["x"], jnp.bfloat16), _j(args["w"], jnp.bfloat16)] + [
        _j(args[k]) for k in ("bias", "gamma", "beta", "film_scale", "film_shift")
    ]
    want, vjp = jax.vjp(fused_j, *jargs)
    want_grads = vjp(jnp.asarray(cot))

    leaves = [_t(args["x"], torch.bfloat16), _t(args["w"], torch.bfloat16)] + [
        _t(args[k]) for k in ("bias", "gamma", "beta", "film_scale", "film_shift")
    ]
    leaves = [t.requires_grad_() for t in leaves]
    got = conv.norm_act_conv(*leaves[:5], film_scale=leaves[5], film_shift=leaves[6], groups=32, act="silu")
    got.float().backward(torch.from_numpy(cot))
    _close(got.detach().float(), want, rtol=0.06, atol=0.03)
    names = ("dx", "dw", "dbias", "dgamma", "dbeta", "dfilm_scale", "dfilm_shift")
    for name, leaf, ref in zip(names, leaves, want_grads):
        assert leaf.grad is not None, name
        assert leaf.grad.dtype == leaf.dtype, name
        _close(leaf.grad.float(), np.asarray(ref, np.float32), rtol=0.1, atol=0.08)


def test_gn_stats_and_fold_match_jax():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 8, 16, 256)) * 3 + 1).astype(np.float32)
    x[:, :, :, :8] = 5.0  # a constant group: the variance clamp at 0
    gamma, beta = rng.standard_normal(256).astype(np.float32), rng.standard_normal(256).astype(np.float32)
    fs, ft = rng.standard_normal((2, 256)).astype(np.float32), rng.standard_normal((2, 256)).astype(np.float32)
    want_mean, want_rstd = pc.gn_stats(jnp.asarray(x), 32)
    got_mean, got_rstd = conv.gn_stats(torch.from_numpy(x), 32)
    np.testing.assert_allclose(got_mean.numpy(), want_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_rstd.numpy(), want_rstd, rtol=1e-5, atol=1e-5)
    for film in ((None, None), (fs, ft)):
        want = pc.fold_norm_affine(want_mean, want_rstd, jnp.asarray(gamma), jnp.asarray(beta),
                                   *(None if f is None else jnp.asarray(f) for f in film))
        got = conv.fold_norm_affine(got_mean, got_rstd, torch.from_numpy(gamma), torch.from_numpy(beta),
                                    *(None if f is None else torch.from_numpy(f) for f in film))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def _gn_stats_composite(x, groups, eps=1e-5):
    """``gn_stats`` as plain torch, differentiated by autograd."""
    b, h, w, c = x.shape
    xg = x.to(torch.float32).reshape(b, h * w, groups, c // groups)
    mean = xg.mean(dim=(1, 3))
    var = torch.clamp(xg.square().mean(dim=(1, 3)) - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    return mean.repeat_interleave(c // groups, 1), rstd.repeat_interleave(c // groups, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gn_stats_backward_equals_autograd_of_the_composite(dtype):
    """The memory-lean backward against autograd through the plain composite,
    f32 at 1e-5; bf16 where both round dx to bf16 once, at one bf16 ulp."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((rng.standard_normal((2, 8, 16, 256)) * 2 + 0.5).astype(np.float32)).to(dtype)
    x[:, :, :, :8] = 3.0  # a constant group: variance clamped at 0
    dm, dr = (torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32)) for _ in range(2))
    got_x = x.clone().requires_grad_()
    mean, rstd = conv.gn_stats(got_x, 32)
    (mean * dm + rstd * dr).sum().backward()
    ref_x = x.clone().requires_grad_()
    ref_mean, ref_rstd = _gn_stats_composite(ref_x, 32)
    (ref_mean * dm + ref_rstd * dr).sum().backward()
    torch.testing.assert_close(mean, ref_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(rstd, ref_rstd, rtol=1e-6, atol=1e-6)
    assert got_x.grad.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got_x.grad.float() - ref_x.grad.float()).abs().max().item()
    assert err <= tol * ref_x.grad.float().abs().max().item(), err


def _dropout_kw(d, rate=0.3, seed=7):
    return dict(scale=_t(d["scale"]), shift=_t(d["shift"]), act="silu", dropout_rate=rate, seed=seed)


def test_dropout_identity_tap_equals_hash_mask():
    """K2's plain version with an identity centre tap returns its normalized
    input: it must equal dropout(silu(x·a + c)) with the mask of ``hash_mask``
    on the NHWC element index, bit for bit; and one seed gives one output."""
    B, H, W, C = 2, 16, 16, 128
    d = _inputs(B, H, W, C, C)
    x = _t(d["x"], torch.bfloat16)
    w_id = torch.zeros(3, 3, C, C)
    w_id[1, 1] = torch.eye(C)
    kw = _dropout_kw(d)
    m = conv.fused_conv3x3(x, w_id, **kw)
    z = x.float() * kw["scale"][:, None, None, :] + kw["shift"][:, None, None, :]
    mask = hash_mask(7, (B, C, H, W), 0.3, torch.float32).permute(0, 2, 3, 1)
    want = (z * torch.sigmoid(z) * mask).to(torch.bfloat16)
    assert torch.equal(m, want)
    assert torch.equal(m, conv.fused_conv3x3(x, w_id, **kw))
    assert not torch.equal(m, conv.fused_conv3x3(x, w_id, **dict(kw, seed=8)))
    dropped = (mask == 0).float().mean().item()
    assert 0.25 < dropped < 0.35, dropped


def _bf16_values(t):
    """``t`` rounded to bf16 values in f32; the gradient passes straight through."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


class _RoundGradBF16(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to bf16."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def test_dropout_core_grads_equal_autograd_through_plain_composite():
    """With dropout on, the core's gradients (K3 → K4, K5) equal torch autograd
    through the plain composite with the explicit mask of the same seed."""
    B, H, W, C, D = 2, 16, 16, 128, 128
    d = _inputs(B, H, W, C, D, seed=3)
    seed, rate = 11, 0.25
    x = _t(d["x"], torch.bfloat16)
    leaves = [_t(d["scale"]).requires_grad_(), _t(d["shift"]).requires_grad_(),
              _t(d["w"]).requires_grad_(), _t(d["bias"]).requires_grad_(), x.clone().requires_grad_()]
    scale, shift, w, bias, xl = leaves
    y = conv._NormActConvCore.apply(xl, scale, shift, w, bias, "silu", rate, seed)
    dy = _t(d["dy"], torch.bfloat16)
    y.backward(dy)
    got = [t.grad.clone() for t in leaves]

    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves[:4]] + [x.float().requires_grad_()]
    rs, rt, rw, rb, rx = ref_leaves
    z = rx * rs[:, None, None, :] + rt[:, None, None, :]
    n = z * torch.sigmoid(z) * conv.keep_mask(seed, x.shape, rate)
    # n rounded to bf16 as the core rounds it; dn rounded to bf16 as K3 rounds it
    n = _RoundGradBF16.apply(_bf16_values(n))
    yr = torch.nn.functional.conv2d(
        n.permute(0, 3, 1, 2), _bf16_values(rw).permute(3, 2, 0, 1), padding=1
    ).permute(0, 2, 3, 1) + rb
    torch.testing.assert_close(y.float(), yr.to(torch.bfloat16).float(), rtol=0, atol=0)
    yr.backward(dy.float())
    names = ("dscale", "dshift", "dw", "dbias", "dx")
    for name, g, r in zip(names, got, ref_leaves):
        tol = BF16_TOL if name == "dx" else SUM_TOL
        _close(g.float(), r.grad.float(), **tol)


def test_supported_on_flagship_shapes_and_refused_ones():
    for hw, c, d in FLAGSHIP:
        side = int(hw ** 0.5)
        assert conv.supported((32, side, side, c), (3, 3, c, d)), (hw, c, d)
        assert conv.supported((32, side, side, c), (3, 3, c, d)) == pc.supported(
            (32, side, side, c), (3, 3, c, d)
        )
    refused = [
        ((2, 32, 32, 96), (3, 3, 96, 128)),     # C not a multiple of 128
        ((2, 32, 32, 128), (3, 3, 128, 64)),    # D not a multiple of 128
        ((2, 32, 8, 128), (3, 3, 128, 128)),    # W not a multiple of 16
        ((2, 4, 16, 128), (3, 3, 128, 128)),    # H < 8
        ((2, 32, 32, 128), (1, 1, 128, 128)),   # not 3×3
        ((2, 32, 32, 128), (3, 3, 256, 128)),   # channel mismatch
        ((32, 32, 128), (3, 3, 128, 128)),      # not 4-D
    ]
    for xs, ws in refused:
        assert not conv.supported(xs, ws)
        assert conv.supported(xs, ws) == pc.supported(xs, ws)


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("hw,c,d", FLAGSHIP + [(RAGGED[1] * RAGGED[2], RAGGED[3], RAGGED[4])])
def test_wgrad_geometry_covers_each_tile_once_within_the_scratch_budget(hw, c, d, sms):
    """K5's split (``conv.wgrad_geometry``), walked as the kernel walks it: every
    8 x 16 pixel tile is summed once per channel block, and dbias once per D
    tile (by the C tile ``j % (C/64)`` of each split's walk); the grid is one
    wave (at most one block an SM, as many splits as fit); the f32 partials
    stay under 256 MiB at batch 32."""
    if (hw, c, d) == (RAGGED[1] * RAGGED[2], RAGGED[3], RAGGED[4]):
        b, h, w = RAGGED[0], RAGGED[1], RAGGED[2]
    else:
        b, h = 32, int(hw ** 0.5)
        w = h
    splits, scratch = conv.wgrad_geometry(b, h, w, c, d, sms)
    tiles = b * -(-h // 8) * (w // 16)
    c_tiles, blocks = c // 64, (c // 64) * (d // 64)
    assert 1 <= splits <= tiles
    assert scratch == (splits, 9 * c * d + c_tiles * d)
    assert scratch[0] * scratch[1] * 4 < 256 * 2**20
    walked = sorted(pt for split in range(splits) for pt in range(split, tiles, splits))
    assert walked == list(range(tiles))
    bias_tiles = sorted(split + j * splits for ci in range(c_tiles) for split in range(splits)
                        for j in range(-(-(tiles - split) // splits)) if j % c_tiles == ci)
    assert bias_tiles == list(range(tiles))
    assert splits == 1 or splits * blocks <= sms
    if splits < tiles:
        assert (splits + 1) * blocks > sms


def test_flagship_k4_shapes_are_the_fused_convs_inputs():
    assert len(FLAGSHIP_K4) == 44
    assert {(hw, c) for hw, c, _ in FLAGSHIP} < set(FLAGSHIP_K4)
    assert all(conv.supported((32, int(hw ** 0.5), int(hw ** 0.5), c), (3, 3, c, 128)) for hw, c in FLAGSHIP_K4)


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("hw,c", sorted(set(FLAGSHIP_K4)) + [(RAGGED[1] * RAGGED[2], RAGGED[3])])
def test_prologue_grad_geometry_covers_each_pixel_once(hw, c, sms):
    """K4's slices (``conv.prologue_grad_geometry``), walked as the kernel walks
    them: each block's 16 pixel lanes step 64 pixels at a time through its
    slice, so every pixel of every image is reduced exactly once and written
    into the block's own partial, inside the (2, B, slices, C) scratch; at the
    flagship's shapes (batch 32) the grid fills at least two waves of the
    card's K4 occupancy."""
    b = RAGGED[0] if (hw, c) == (RAGGED[1] * RAGGED[2], RAGGED[3]) else 32
    slice_px, slices = conv.prologue_grad_geometry(b, hw, c, sms)
    assert slice_px % conv._K4_STEP_PX == 0 and slices == -(-hw // slice_px)
    walked = []
    for s in range(slices):
        p_end = min(hw, (s + 1) * slice_px)
        for p0 in range(s * slice_px, p_end, conv._K4_STEP_PX):
            walked += [p for p in range(p0, p0 + conv._K4_STEP_PX) if p < p_end]
    assert walked == list(range(hw))
    last_partial = ((b - 1) * slices + slices - 1) * c + c - 1
    assert last_partial < b * slices * c
    assert 2 * b * slices * c * 4 <= 16 * 2**20
    blocks = b * slices * (c // conv._K4_CHANNELS)
    if b == 32:
        assert blocks >= 2 * conv._K4_BLOCKS_PER_SM * sms


def test_wrappers_refuse_other_devices_and_bad_arguments():
    x = torch.zeros(1, 8, 16, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv.fused_conv3x3(x, torch.zeros(3, 3, 128, 128, device="meta"))
    with pytest.raises(ValueError, match="dropout_rate"):
        conv._prologue_args(x, None, None, None, 1.0, 0, "k")
    with pytest.raises(ValueError, match="both scale and shift"):
        conv._prologue_args(x, torch.zeros(1, 128), None, "silu", 0.0, 0, "k")


def test_build_digest_covers_the_headers(tmp_path, monkeypatch):
    """Editing a shared ``.cuh`` changes every library's name, so no stale
    library survives a header edit."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("S2S_TORCH_BUILD_DIR", str(tmp_path / "build"))
    assert (csrc / "conv_common.cuh").is_file()
    before = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert all(p.parent == tmp_path / "build" for p in before.values())
    header = csrc / "conv_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build._lib_path(s) for s in _build.SOURCES}
    assert all(before[s] != after[s] for s in _build.SOURCES)
    # the name still carries the source's own hash too
    src = csrc / "conv3x3_fwd.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._lib_path("conv3x3_fwd.cu") != after["conv3x3_fwd.cu"]
    assert _build._lib_path("prologue_grad.cu") == after["prologue_grad.cu"]

"""PyTorch port vs the JAX package: leaf ops of the serving and training
paths, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; JAX runs in
f32 with ``jax.default_matmul_precision("highest")``. Layouts: the port's
norms and dropout take NCHW (its UNet's internal layout), the JAX ones NHWC.
Gradients are held against ``jax.vjp`` of the JAX function with the same
cotangent. Randomness (t, noise, crop offsets, flips) is drawn once and
handed to both packages; the dropout mask is compared bit for bit.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.ops import cfm as jcfm
from stain2stain_tpu.ops import norms as jnorms
from stain2stain_tpu.ops import solvers as jsolvers
from stain2stain_tpu.ops.dropout import _hash_mask as j_hash_mask
from stain2stain_tpu.ops.dropout import hash_dropout as j_hash_dropout
from stain2stain_tpu.ops.image import paired_random_crop_flip as j_crop_flip
from stain2stain_tpu.ops.losses import mse_loss as j_mse_loss
from stain2stain_tpu.ops.image import denormalize_np as j_denormalize_np
from stain2stain_tpu.ops.image import normalize_uint8_np as j_normalize_uint8_np
from stain2stain_tpu.ops.pallas_attention import attention as j_attention
from stain2stain_tpu.ops.time_embedding import timestep_embedding_adm as j_time_embedding
from stain2stain_tpu_torch import ops
from stain2stain_tpu_torch.ops import attention as tattn
from stain2stain_tpu_torch.ops import cfm as tcfm
from stain2stain_tpu_torch.ops import dropout as tdropout
from stain2stain_tpu_torch.ops import image as timage
from stain2stain_tpu_torch.ops import norms as tnorms
from stain2stain_tpu_torch.ops import solvers as tsolvers
from stain2stain_tpu_torch.ops.losses import mse_loss as t_mse_loss
from stain2stain_tpu_torch.ops.time_embedding import timestep_embedding_adm as t_time_embedding

TOL = 1e-5  # f32 on both sides; only the summation order differs


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("dim", [32, 33, 128])
def test_timestep_embedding_adm(dim):
    t = np.random.default_rng(0).uniform(0, 1, size=(5,)).astype(np.float32)
    ref = np.asarray(j_time_embedding(jnp.asarray(t), dim))
    got = t_time_embedding(torch.from_numpy(t), dim).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("variant", ["plain", "silu", "film_silu"])
@pytest.mark.parametrize("channels,groups", [(32, 8), (48, 16)])
def test_group_norms(variant, channels, groups):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 6, 5, channels)) * 3 + 1.5).astype(np.float32)
    gamma = rng.standard_normal(channels).astype(np.float32)
    beta = rng.standard_normal(channels).astype(np.float32)
    scale = rng.standard_normal((2, 1, 1, channels)).astype(np.float32) * 0.5
    shift = rng.standard_normal((2, 1, 1, channels)).astype(np.float32) * 0.5
    tg, tb = torch.from_numpy(gamma), torch.from_numpy(beta)
    if variant == "plain":
        ref = jnorms.group_norm(jnp.asarray(x), gamma, beta, groups)
        got = tnorms.group_norm(_nchw(x), tg, tb, groups)
    elif variant == "silu":
        ref = jnorms.group_norm_silu(jnp.asarray(x), gamma, beta, groups)
        got = tnorms.group_norm_silu(_nchw(x), tg, tb, groups)
    else:
        ref = jnorms.group_norm_film_silu(jnp.asarray(x), gamma, beta, scale, shift, groups)
        got = tnorms.group_norm_film_silu(_nchw(x), tg, tb, _nchw(scale), _nchw(shift), groups)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(ref), atol=TOL, rtol=TOL)


def test_group_norm_keeps_dtype_and_handles_zero_variance():
    x = torch.full((1, 4, 3, 3), 7.0, dtype=torch.bfloat16)  # constant groups: var = 0
    y = tnorms.group_norm(x, torch.ones(4), torch.zeros(4), 2)
    assert y.dtype == torch.bfloat16
    assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 8), (1, 37, 2, 32), (1, 70, 2, 16), (2, 70, 1, 64)])
def test_attention_matches_jax_einsum(b, t, h, d):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d, use_fused=False))
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), d)
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_fused_attention_cpu_is_the_plain_version():
    """On CPU tensors the K1 wrapper runs its plain (BH, T, d) version, which
    agrees with the (B, T, H, d) path after folding; no launch is counted."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 20, 3, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32)) for _ in range(3))

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()

    before = ops.launches()["K1-fwd"]
    out = tattn.fused_attention(fold(q), fold(k), fold(v), 1.0 / math.sqrt(d))
    assert ops.launches()["K1-fwd"] == before
    ref = tattn.attention_reference(q, k, v, d)
    np.testing.assert_allclose(out.reshape(b, h, t, d).permute(0, 2, 1, 3).numpy(), ref.numpy(), atol=TOL, rtol=TOL)
    bf = tattn.fused_attention(fold(q).bfloat16(), fold(k).bfloat16(), fold(v).bfloat16(), 0.25)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "shape,dtype,err",
    [
        ((4, 10, 8), torch.float32, ValueError),  # head dim the kernel lacks
        ((4, 10, 32), torch.float16, TypeError),  # dtype the kernel lacks
        ((4, 10), torch.float32, ValueError),  # not (BH, T, d)
    ],
)
def test_fused_attention_rejects_what_the_kernel_does_not_take(shape, dtype, err):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(err):
        tattn._check(x, x, x)


def test_fused_attention_rejects_non_contiguous():
    x = torch.zeros(4, 32, 10).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tattn._check(x, x, x)


def test_image_normalization_twins():
    img = np.random.default_rng(4).integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timage.normalize_uint8_np(img), j_normalize_uint8_np(img))
    x = timage.normalize_uint8(torch.from_numpy(img))
    np.testing.assert_allclose(x.numpy(), j_normalize_uint8_np(img), atol=1e-7)
    y = np.linspace(-1.5, 1.5, 30, dtype=np.float32)
    np.testing.assert_array_equal(timage.denormalize_np(y), j_denormalize_np(y))
    np.testing.assert_allclose(timage.denormalize(torch.from_numpy(y)).numpy(), j_denormalize_np(y))


def _linear_field(a: np.ndarray):
    """dx/dt = A·x + sin(3t): a smooth field both packages evaluate alike."""

    def jfn(t, x):
        return x @ jnp.asarray(a) + jnp.sin(3.0 * t)

    ta = torch.from_numpy(a)

    def tfn(t, x):
        return x @ ta + torch.sin(3.0 * t)

    return jfn, tfn


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_fixed_step_solvers(method):
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((4, 4)) * 0.5).astype(np.float32)
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    jfn, tfn = _linear_field(a)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jsolvers.odeint_fixed(jfn, jnp.asarray(x0), 5, method=method))
    got = tsolvers.odeint_fixed(tfn, torch.from_numpy(x0), 5, method=method).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_dopri5_same_evaluations_and_state():
    rng = np.random.default_rng(6)
    a = (rng.standard_normal((4, 4)) * 2.0).astype(np.float32)
    x0 = rng.standard_normal((3, 4)).astype(np.float32)
    jfn, tfn = _linear_field(a)
    j_calls = []

    def jcounted(t, x):
        jax.debug.callback(lambda: j_calls.append(1))
        return jfn(t, x)

    t_calls = []

    def tcounted(t, x):
        t_calls.append(1)
        return tfn(t, x)

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jsolvers.odeint_dopri5(jcounted, jnp.asarray(x0)))
    got = tsolvers.odeint_dopri5(tcounted, torch.from_numpy(x0)).numpy()
    assert len(t_calls) == len(j_calls) > 7
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_dopri5_warns_when_it_stops_short():
    with pytest.warns(RuntimeWarning, match="dopri5 stopped"):
        tsolvers.odeint_dopri5(lambda t, x: 50.0 * torch.sin(40.0 * t) * x, torch.ones(2), max_steps=2)


def test_solver_config_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown solver"):
        tsolvers.SolverConfig("leapfrog")


# ---------------------------------------------------------------- training ops


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 8), (1, 37, 2, 32), (2, 70, 1, 16)])
def test_attention_backward_matches_jax_vjp(b, t, h, d):
    """``attention`` → FusedAttention → the plain K1-bwd on CPU tensors, against
    ``jax.vjp`` of the JAX package's CPU attention path."""
    rng = np.random.default_rng(20)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    with jax.default_matmul_precision("highest"):
        ref_out, vjp = jax.vjp(lambda *a: j_attention(*a, d, use_fused=False), *map(jnp.asarray, (q, k, v)))
        ref_grads = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.attention(*leaves, d)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_fused_attention_backward_reference_is_the_vjp_of_the_plain_forward():
    """The explicit K1-bwd identities equal autograd through the plain K1-fwd;
    CPU tensors launch nothing."""
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((3, 29, 16)).astype(np.float32)) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tattn.fused_attention_reference(*leaves, 0.3)
    auto = torch.autograd.grad(out, leaves, do)
    before = ops.launches()["K1-bwd"]
    got = tattn.fused_attention_backward(q, k, v, out.detach(), do, 0.3)
    assert ops.launches()["K1-bwd"] == before
    for a, b in zip(got, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)
    bf = tattn.fused_attention_backward(*(x.bfloat16() for x in (q, k, v, out.detach(), do)), 0.3)
    assert all(g.dtype == torch.bfloat16 for g in bf)


@pytest.mark.parametrize("bh,t,d,peak", [(6, 37, 16, 1.0), (2, 70, 32, 1.0), (3, 70, 64, 8.0)])
def test_fused_attention_lse_matches_jax_logsumexp(bh, t, d, peak):
    """The plain K1-fwd's optional row log-sum-exp against ``jax.nn.logsumexp``
    of the f32 logits as the JAX kernel forms them (``_fwd_kernel``: q·scale
    dotted with k); ``peak`` scales q, so the rows' softmax is near one-hot."""
    rng = np.random.default_rng(23)
    q, k, v = (rng.standard_normal((bh, t, d)).astype(np.float32) for _ in range(3))
    q *= peak
    scale = 1.0 / math.sqrt(d)
    with jax.default_matmul_precision("highest"):
        logits = jax.lax.dot_general(jnp.asarray(q) * scale, jnp.asarray(k), (((2,), (2,)), ((0,), (0,))))
        ref = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    out, lse = tattn.fused_attention(*map(torch.from_numpy, (q, k, v)), scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (bh, t)
    np.testing.assert_allclose(lse.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(out.numpy(), tattn.fused_attention(*map(torch.from_numpy, (q, k, v)), scale).numpy())


@pytest.mark.parametrize("b,t,h,d,peak", [(1, 37, 2, 32, 1.0), (2, 70, 1, 16, 1.0), (1, 37, 2, 32, 8.0),
                                          (2, 70, 1, 16, 8.0)])
def test_attention_backward_through_the_saved_lse_matches_jax_vjp(monkeypatch, b, t, h, d, peak):
    """``attention`` → FusedAttention: the forward saves its lse and the
    backward's p = exp(s − lse) comes from it, against ``jax.vjp`` of the JAX
    package's plain attention; ragged T, and peaked logits (q × 8), where the
    online softmax's rescale matters on the card. The gradients' tolerance is
    TOL × peak: f32 rounding in either package grows with the logits, which
    the peak multiplies (at q × 8 JAX's own f32 dk lies up to 4e-5 from an f64
    evaluation of the same formulas, the port's within 1.5e-5)."""
    rng = np.random.default_rng(24)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    q *= peak
    with jax.default_matmul_precision("highest"):
        ref_out, vjp = jax.vjp(lambda *a: j_attention(*a, d, use_fused=False), *map(jnp.asarray, (q, k, v)))
        ref_grads = vjp(jnp.asarray(do))
    seen = []
    plain = tattn.fused_attention_backward_reference

    def spy(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(tattn, "fused_attention_backward_reference", spy)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.attention(*leaves, d)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert len(seen) == 1 and seen[0] is not None and seen[0].shape == (b * h, t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), atol=TOL, rtol=TOL)
    for got, ref in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL * peak, rtol=TOL)


@pytest.mark.parametrize("peak", [1.0, 8.0])
def test_fused_attention_backward_with_and_without_lse_agree(peak):
    """Both routes of K1-bwd's plain version on CPU tensors: the forward's lse
    given, or the softmax recomputed."""
    rng = np.random.default_rng(25)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, 45, 32)).astype(np.float32)) for _ in range(4))
    q = q * peak
    out, lse = tattn.fused_attention(q, k, v, 0.2, return_lse=True)
    with_lse = tattn.fused_attention_backward(q, k, v, out, do, 0.2, lse)
    without = tattn.fused_attention_backward(q, k, v, out, do, 0.2)
    for a, b in zip(with_lse, without):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=TOL)


def test_fused_attention_rejects_a_misshapen_lse_and_misaligned_tensors():
    q = torch.zeros(4, 10, 16)
    with pytest.raises(ValueError, match="lse"):
        tattn._check_lse(torch.zeros(4, 11), q)
    with pytest.raises(ValueError, match="lse"):
        tattn._check_lse(torch.zeros(4, 10, dtype=torch.bfloat16), q)
    tattn._check_lse(torch.zeros(4, 10), q)
    shifted = torch.zeros(4 * 10 * 16 + 1)[1:].view(4, 10, 16)  # starts 4 bytes past an aligned address
    with pytest.raises(ValueError, match="aligned"):
        tattn._check(shifted, shifted, shifted)


@pytest.mark.parametrize("variant", ["plain", "silu", "film_silu"])
@pytest.mark.parametrize("channels,groups", [(32, 8), (48, 16)])
def test_group_norm_gradients_match_jax_vjp(variant, channels, groups):
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((2, 6, 5, channels)) * 3 + 1.5).astype(np.float32)
    gamma = rng.standard_normal(channels).astype(np.float32)
    beta = rng.standard_normal(channels).astype(np.float32)
    scale = (rng.standard_normal((2, 1, 1, channels)) * 0.5).astype(np.float32)
    shift = (rng.standard_normal((2, 1, 1, channels)) * 0.5).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    if variant == "plain":
        jfn = lambda x, g, b: jnorms.group_norm(x, g, b, groups)  # noqa: E731
        jargs, targs = (x, gamma, beta), (_nchw(x), gamma, beta)
        tfn = lambda x, g, b: tnorms.group_norm(x, g, b, groups)  # noqa: E731
    elif variant == "silu":
        jfn = lambda x, g, b: jnorms.group_norm_silu(x, g, b, groups)  # noqa: E731
        jargs, targs = (x, gamma, beta), (_nchw(x), gamma, beta)
        tfn = lambda x, g, b: tnorms.group_norm_silu(x, g, b, groups)  # noqa: E731
    else:
        jfn = lambda x, g, b, s, h: jnorms.group_norm_film_silu(x, g, b, s, h, groups)  # noqa: E731
        jargs, targs = (x, gamma, beta, scale, shift), (_nchw(x), gamma, beta, _nchw(scale), _nchw(shift))
        tfn = lambda x, g, b, s, h: tnorms.group_norm_film_silu(x, g, b, s, h, groups)  # noqa: E731
    ref_out, vjp = jax.vjp(jfn, *map(jnp.asarray, jargs))
    ref_grads = vjp(jnp.asarray(dy))
    leaves = [torch.as_tensor(a).clone().requires_grad_() for a in targs]
    out = tfn(*leaves)
    grads = torch.autograd.grad(out, leaves, _nchw(dy))
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), atol=TOL, rtol=TOL)
    for i, (got, ref) in enumerate(zip(grads, ref_grads)):
        got = got.numpy()
        if got.ndim == 4:  # x, scale, shift: NCHW → NHWC
            got = got.transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL, err_msg=f"grad {i}")


def test_group_norm_backward_keeps_the_compute_dtype():
    x = torch.randn(2, 8, 4, 4).bfloat16().requires_grad_()
    gamma, beta = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    tnorms.group_norm_silu(x, gamma, beta, 4).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and gamma.grad.dtype == torch.float32
    assert torch.isfinite(x.grad.float()).all()


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 7, 2**32 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_dropout_mask_is_bit_identical_to_jax(seed, rate):
    """Same uint32 seed, same NHWC element index → the same mask, bit for bit."""
    shape_nhwc = (2, 5, 7, 6)
    ref = np.asarray(j_hash_mask(jnp.uint32(seed), shape_nhwc, rate, jnp.float32))
    got = tdropout.hash_mask(seed, (2, 6, 5, 7), rate, torch.float32)
    np.testing.assert_array_equal(_nhwc(got), ref)
    bits = tdropout.hash_bits(seed, (2, 6, 5, 7))
    assert bits.dtype == torch.int32


def test_hash_dropout_forward_and_gradient_match_jax():
    """y = x·mask and dx = dy·(the same mask), as JAX's custom VJP."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 4, 3, 8)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    seed, rate = 987654321, 0.3
    ref_out, vjp = jax.vjp(lambda a: j_hash_dropout(a, jnp.uint32(seed), rate), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(dy))
    xt = _nchw(x).requires_grad_()
    out = tdropout.hash_dropout(xt, seed, rate)
    (dx,) = torch.autograd.grad(out, xt, _nchw(dy))
    np.testing.assert_array_equal(_nhwc(out), np.asarray(ref_out))
    np.testing.assert_array_equal(_nhwc(dx), np.asarray(ref_dx))
    mask = tdropout.hash_mask(seed, xt.shape, rate, torch.float32)
    torch.testing.assert_close(dx, _nchw(dy) * mask, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
def test_hash_dropout_keeps_the_plain_path_on_cpu_tensors(dtype):
    """CPU tensors, of any float dtype, take the plain ``x * hash_mask(...)``
    both ways and never count a launch of the card's kernel."""
    ops.zero_launches()
    x = torch.randn(2, 6, 5, 7).to(dtype).requires_grad_()
    dy = torch.randn(x.shape).to(dtype)
    y = tdropout.hash_dropout(x, 2**31 + 7, 0.1)
    (dx,) = torch.autograd.grad(y, x, dy)
    mask = tdropout.hash_mask(2**31 + 7, x.shape, 0.1, dtype)
    assert torch.equal(y, x.detach() * mask) and torch.equal(dx, dy * mask)
    assert ops.launches()["dropout"] == 0


def test_hash_dropout_kernel_refuses_dtypes_it_does_not_take():
    """The card's path checks the dtype before it builds or launches anything."""
    with pytest.raises(TypeError, match="float64"):
        tdropout._launch_hash_dropout(torch.ones(2, 6, 5, 7, dtype=torch.float64), 12345, 0.1)


def test_fast_dropout_modes():
    drop = tdropout.FastDropout(0.5)
    x = torch.ones(2, 3, 4, 4)
    drop.eval()
    assert drop(x) is x
    drop.train()
    a = drop(x, torch.Generator().manual_seed(5))
    b = drop(x, torch.Generator().manual_seed(5))
    c = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) <= {0.0, 2.0}
    assert tdropout.FastDropout(0.0).train()(x) is x
    assert not any(True for _ in drop.parameters())
    assert tdropout.FastDropout(0.1, impl="bits").impl == "bits"  # JAX's hardware_dropout, ported
    with pytest.raises(NotImplementedError):
        tdropout.FastDropout(0.1, impl="rbg")


@pytest.mark.parametrize("sigma", [0.0, 0.2])
def test_conditional_flow_matcher_with_injected_draws(sigma):
    rng = np.random.default_rng(24)
    x0, x1 = (rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    t = rng.uniform(0, 1, (3,)).astype(np.float32)
    key = jax.random.key(3)
    jm = jcfm.ConditionalFlowMatcher(sigma=sigma)
    ref_xt = np.asarray(jm.sample_xt(key, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t)))
    ref_ut = np.asarray(jm.conditional_flow(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(t)))
    eps = np.array(jax.random.normal(key, x0.shape, dtype=jnp.float32))  # JAX's own noise draw
    tt, xt, ut = tcfm.ConditionalFlowMatcher(sigma=sigma).sample_location_and_conditional_flow(
        torch.from_numpy(x0), torch.from_numpy(x1), t=torch.from_numpy(t), eps=torch.from_numpy(eps)
    )
    np.testing.assert_allclose(xt.numpy(), ref_xt, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ut.numpy(), ref_ut, atol=TOL, rtol=TOL)
    assert tt.dtype == torch.float32 and tt.shape == (3,)


def test_target_conditional_flow_matcher_with_injected_draws():
    rng = np.random.default_rng(25)
    x0, x1 = (rng.uniform(-1, 1, (2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.key(4)
    jm = jcfm.TargetConditionalFlowMatcher(sigma=0.1)
    ref_t, ref_xt, ref_ut = (np.array(a) for a in jm.sample_location_and_conditional_flow(key, x0, x1))
    _, x_key = jax.random.split(key)
    eps = np.array(jax.random.normal(x_key, x1.shape, dtype=jnp.float32))
    _, xt, ut = tcfm.TargetConditionalFlowMatcher(sigma=0.1).sample_location_and_conditional_flow(
        torch.from_numpy(x0), torch.from_numpy(x1), t=torch.from_numpy(ref_t), eps=torch.from_numpy(eps)
    )
    np.testing.assert_allclose(xt.numpy(), ref_xt, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ut.numpy(), ref_ut, atol=1e-4, rtol=1e-4)


def test_flow_matcher_draws_from_the_generator():
    m = tcfm.ConditionalFlowMatcher()
    x0, x1 = torch.zeros(4, 2, 2, 3), torch.ones(4, 2, 2, 3)
    a = m.sample_location_and_conditional_flow(x0, x1, generator=torch.Generator().manual_seed(1))
    b = m.sample_location_and_conditional_flow(x0, x1, generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert ((a[0] >= 0) & (a[0] < 1)).all()


def test_mse_loss_matches_jax():
    rng = np.random.default_rng(26)
    a, b = (rng.standard_normal((2, 5, 5, 3)).astype(np.float32) for _ in range(2))
    ref = float(j_mse_loss(jnp.asarray(a), jnp.asarray(b)))
    got = t_mse_loss(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(t_mse_loss(torch.from_numpy(a), torch.from_numpy(b))), ref, rtol=1e-6)


@pytest.mark.parametrize("hflip,vflip", [(True, True), (False, True), (True, False)])
def test_paired_random_crop_flip_with_injected_draws(hflip, vflip):
    """The JAX function's own crop offsets and flip bits, handed to the port,
    give the same pixels for every array of the group."""
    rng = np.random.default_rng(27)
    src = rng.integers(0, 256, (3, 12, 10, 3)).astype(np.float32)
    mask = rng.integers(0, 2, (3, 12, 10, 1)).astype(np.float32)
    key = jax.random.key(9)
    ref = j_crop_flip(key, [jnp.asarray(src), jnp.asarray(mask)], crop_size=6, hflip=hflip, vflip=vflip)
    top_key, left_key, h_key, v_key = jax.random.split(key, 4)
    draws = dict(
        tops=np.array(jax.random.randint(top_key, (3,), 0, 12 - 6 + 1)),
        lefts=np.array(jax.random.randint(left_key, (3,), 0, 10 - 6 + 1)),
        flip_h=np.array(jax.random.bernoulli(h_key, 0.5, (3,))) if hflip else np.zeros(3, bool),
        flip_v=np.array(jax.random.bernoulli(v_key, 0.5, (3,))) if vflip else np.zeros(3, bool),
    )
    got = timage.paired_random_crop_flip(
        [torch.from_numpy(src), torch.from_numpy(mask)], crop_size=6, hflip=hflip, vflip=vflip,
        **{k: torch.from_numpy(v) for k, v in draws.items()},
    )
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_paired_random_crop_flip_draws_from_the_generator():
    imgs = [torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)] * 2
    a = timage.paired_random_crop_flip(imgs, 5, generator=torch.Generator().manual_seed(3))
    b = timage.paired_random_crop_flip(imgs, 5, generator=torch.Generator().manual_seed(3))
    assert a[0].shape == (2, 5, 5, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[0], a[1])

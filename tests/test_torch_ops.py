"""PyTorch port vs the JAX package: leaf ops of the serving path, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; JAX runs in
f32 with ``jax.default_matmul_precision("highest")``. Layouts: the port's
norms take NCHW (its UNet's internal layout), the JAX norms NHWC.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.ops import norms as jnorms
from stain2stain_tpu.ops import solvers as jsolvers
from stain2stain_tpu.ops.image import denormalize_np as j_denormalize_np
from stain2stain_tpu.ops.image import normalize_uint8_np as j_normalize_uint8_np
from stain2stain_tpu.ops.pallas_attention import attention as j_attention
from stain2stain_tpu.ops.time_embedding import timestep_embedding_adm as j_time_embedding
from stain2stain_tpu_torch.ops import attention as tattn
from stain2stain_tpu_torch.ops import image as timage
from stain2stain_tpu_torch.ops import norms as tnorms
from stain2stain_tpu_torch.ops import solvers as tsolvers
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


@pytest.mark.parametrize("b,t,h,d", [(2, 16, 4, 8), (1, 37, 2, 32)])
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

    before = tattn.fused_attention.launches
    out = tattn.fused_attention(fold(q), fold(k), fold(v), 1.0 / math.sqrt(d))
    assert tattn.fused_attention.launches == before
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

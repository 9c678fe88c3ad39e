"""The arithmetic of the f32 attention backward's 3xTF32 design, and the f32
training path that runs it, on the CPU.

``csrc/attention_bwd.cu`` runs the f32 backward's products on the tensor
cores in 3xTF32: each f32 operand x is split into big = tf32(x) and small =
tf32(x - big), rounded as ``cvt.rna.tf32.f32`` rounds (10 mantissa bits, ties
away from zero), and a product a·b is summed as small_a·big_b + big_a·small_b
+ big_a·big_b in f32, one 8-wide slice of the contraction (an ``mma.sync``
m16n8k8) at a time. A CUDA kernel cannot run here, so these tests emulate
that arithmetic in numpy and torch and hold it against the JAX package's VJP
(``jax.default_matmul_precision("highest")``) with the kernel's tolerance on
the card, 2e-5 of max|ref| (``chip_smoke.BWD_REL_TOL``). The port's own CPU
route is unchanged: ``fused_attention_backward`` on CPU tensors runs
``fused_attention_backward_reference``.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from stain2stain_tpu.ops.pallas_attention import attention as j_attention
from stain2stain_tpu_torch.config import compose, instantiate
from stain2stain_tpu_torch.models.unet import AttentionBlock, Downsample
from stain2stain_tpu_torch.ops import attention as tattn

BWD_REL_TOL = chip_smoke.BWD_REL_TOL["float32"]
LOG2E = 1.4426950408889634


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away from zero
    (the kernel's ``tf32_rna``: half a tf32 ulp added to the magnitude's bits,
    the 13 dropped bits cleared)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    big = tf32_rna(x)
    return big, tf32_rna(np.asarray(x, dtype=np.float32) - big)


def _bits(*words: int) -> np.ndarray:
    return np.array(words, dtype=np.uint32).view(np.float32)


@pytest.mark.parametrize(
    "word,rounded",
    [
        (0x3F800000, 0x3F800000),  # 1.0 is a tf32 value
        (0x3F801000, 0x3F802000),  # 1 + 2^-11, a tie: away from zero (even would keep 1.0)
        (0xBF801000, 0xBF802000),  # the negative tie: away from zero too
        (0x3F800FFF, 0x3F800000),  # just below the tie
        (0x3F801001, 0x3F802000),  # just above it
        (0x3F803000, 0x3F804000),  # a tie above an odd last kept bit
        (0x3FFFF000, 0x40000000),  # the carry crosses into the exponent: 2.0
        (0x00001000, 0x00002000),  # a subnormal tie
        (0x80000FFF, 0x80000000),  # a negative subnormal that rounds to -0
        (0x00000000, 0x00000000),
        (0x7F800000, 0x7F800000),  # +inf stays
    ],
)
def test_tf32_rna_on_chosen_bit_patterns(word, rounded):
    got = tf32_rna(_bits(word)).view(np.uint32)[0]
    assert got == rounded, f"{word:#010x} -> {got:#010x}, want {rounded:#010x}"


def test_tf32_split_residual_is_below_2_to_the_minus_22():
    """|x - big - small| <= 2^-22 |x| over seeded inputs of many magnitudes; and
    values with more than 22 significant bits keep a residual (big + small != x)."""
    rng = np.random.default_rng(30)
    x = (rng.standard_normal(200_000) * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    big, small = split_tf32(x)
    assert np.array_equal(tf32_rna(big), big) and np.array_equal(tf32_rna(small), small)
    resid = np.abs(x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert np.all(resid <= 2.0**-22 * np.abs(x.astype(np.float64)))
    # 1 + 4095 * 2^-23: big = 1, x - big has 12 significant bits, small keeps 11
    x = _bits(0x3F800FFF)
    big, small = split_tf32(x)
    assert big[0] == 1.0 and small[0] == 2.0**-11 and big[0] + small[0] != x[0]
    assert abs(float(x[0]) - float(big[0]) - float(small[0])) == 2.0**-23


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b (..., M, K) x (..., K, N) as the kernel sums it: tf32 products, one
    8-wide slice of K at a time into a fresh partial that one f32 add takes
    into the accumulator; ``terms`` 3 is 3xTF32 (small·big, big·small,
    big·big), 1 is 1xTF32 (big·big)."""
    ab, as_ = (torch.from_numpy(h) for h in split_tf32(a.numpy()))
    bb, bs = (torch.from_numpy(h) for h in split_tf32(b.numpy()))
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        part = torch.matmul(ab[..., k], bb[..., k, :])
        if terms == 3:
            part = torch.matmul(as_[..., k], bb[..., k, :]) + torch.matmul(ab[..., k], bs[..., k, :]) + part
        acc = acc + part
    return acc


def tf32_backward(q, k, v, o, do, lse, scale: float, terms: int = 3):
    """The f32 K1-bwd of ``attention_bwd.cu`` emulated on (BH, T, d) f32
    tensors: p = exp2(s·c - lse·log2 e) from the forward's lse, c = scale·log2
    e; delta = rowsum(do∘o); every product through :func:`_mm`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    c = scale * LOG2E
    s = _mm(q, k.transpose(-1, -2), terms)
    p = torch.exp2(s * c - (lse * LOG2E)[..., None])
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = _mm(p.transpose(-1, -2).contiguous(), do, terms)
    ds = p * (_mm(do, v.transpose(-1, -2), terms) - delta)
    dq = _mm(ds, k, terms) * scale
    dk = _mm(ds.transpose(-1, -2).contiguous(), q, terms) * scale
    return dq, dk, dv


def _against_jax_vjp(b, t, h, d, peak, terms):
    """(max abs error over dq, dk, dv, max|ref|) of the emulation against
    ``jax.vjp`` of the JAX package's plain attention, on (B, T, H, d) inputs."""
    rng = np.random.default_rng(31)
    q, k, v, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(4))
    q *= peak
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda *a: j_attention(*a, d, use_fused=False), *map(jnp.asarray, (q, k, v)))
        ref = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    def fold(x):  # (B, T, H, d) -> (B*H, T, d), as ops.attention folds
        return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d)))

    qf, kf, vf, dof = map(fold, (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    o, lse = tattn.fused_attention_reference(qf, kf, vf, scale, return_lse=True)  # K1-fwd's o and lse
    got = tf32_backward(qf, kf, vf, o, dof, lse, scale, terms)
    got = [g.numpy().reshape(b, h, t, d).transpose(0, 2, 1, 3) for g in got]
    err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    return err, max(float(np.abs(r).max()) for r in ref)


@pytest.mark.parametrize(
    "b,t,h,d,peak",
    [
        (2, 16, 4, 16, 1.0),
        (1, 37, 2, 32, 1.0),
        (2, 70, 1, 16, 1.0),
        (1, 70, 2, 64, 1.0),
        (1, 37, 2, 32, 8.0),
        (2, 70, 1, 16, 8.0),
        (1, 70, 2, 64, 8.0),
    ],
)
def test_3xtf32_backward_meets_the_f32_budget_against_jax_vjp(b, t, h, d, peak):
    """The kernel's 3xTF32 arithmetic at d 16, 32 and 64, ragged T 37 and 70 and
    peaked logits (q × 8): within 2e-5 of max|ref| of the JAX VJP."""
    err, ref_max = _against_jax_vjp(b, t, h, d, peak, terms=3)
    assert err <= BWD_REL_TOL * ref_max, (err, ref_max)


@pytest.mark.parametrize("b,t,h,d", [(1, 37, 2, 32), (2, 70, 1, 16), (1, 70, 2, 64)])
def test_1xtf32_misses_the_budget_that_3xtf32_meets(b, t, h, d):
    """big·big alone (1xTF32) at peaked logits lies at least 10× further from
    the JAX VJP than 3xTF32, and outside the f32 budget: why all three terms."""
    err3, ref_max = _against_jax_vjp(b, t, h, d, 8.0, terms=3)
    err1, _ = _against_jax_vjp(b, t, h, d, 8.0, terms=1)
    assert err1 >= 10 * err3, (err1, err3)
    assert err1 > BWD_REL_TOL * ref_max, (err1, ref_max)


def _rz(x: np.ndarray) -> np.ndarray:
    """float64 → float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mm_rz(a: np.ndarray, b: np.ndarray, fresh: bool) -> np.ndarray:
    """3xTF32 a @ b with each mma's sum (its exact products plus C) rounded
    toward zero, a model of the tensor cores' f32 sums; ``fresh``: each 8-wide
    slice's three mma's start from zero and one round-to-nearest f32 add takes
    the partial into the accumulator (the kernel's ``mma3_tf32``), else the
    mma's accumulate into it directly."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        part = np.zeros_like(acc) if fresh else acc
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            part = _rz(part.astype(np.float64) + x[:, k].astype(np.float64) @ y[k].astype(np.float64))
        acc = acc + part if fresh else part
    return acc


def test_fresh_partials_keep_round_toward_zero_sums_at_f32_accuracy():
    """Why ``mma3_tf32`` adds a fresh partial per mma triple: with every mma's
    sum rounded toward zero, one accumulator carried over T 1024 keys drifts
    at least 10× further from the exact dq = ds·k than fresh partials do,
    which stay within the f32 budget."""
    rng = np.random.default_rng(32)
    t, d = 1024, 32
    ds = (rng.standard_normal((t, t)) * 0.03).astype(np.float32)
    k = rng.standard_normal((t, d)).astype(np.float32)
    exact = ds.astype(np.float64) @ k.astype(np.float64)
    err = {fresh: float(np.abs(_mm_rz(ds, k, fresh) - exact).max()) for fresh in (False, True)}
    assert err[False] >= 10 * err[True], err
    assert err[True] <= BWD_REL_TOL * np.abs(exact).max(), err


def test_train_f32_overrides_give_one_attention_block_at_the_512px_shape(monkeypatch):
    """``chip_smoke``'s train-f32 overrides compose to f32, 512-px tiles and
    batch 6; the flagship built from them has one attention block, the middle
    one, whose K1 calls run at (6·16, 4096, 32)."""
    repo = Path(chip_smoke.__file__).resolve().parent
    cfg = compose(repo / "configs", "train.yaml", chip_smoke.TRAIN_F32_OVERRIDES)
    assert cfg.trainer.precision in (32, "32")
    assert (cfg.data.tile_size, cfg.data.image_size, cfg.data.batch_size) == (512, 512, 6)
    assert (cfg.data.n_train // cfg.data.batch_size, cfg.trainer.max_epochs) == (8, 1)  # 8 steps
    net = instantiate(cfg.model.net, device="cpu")
    blocks = [m for m in net.modules() if isinstance(m, AttentionBlock)]
    assert blocks == [net.middle_block[1]]

    seen = []

    def record(q, k, v, scale, return_lse=False):  # the shape K1 would see, without the (T, T) work
        seen.append(tuple(q.shape))
        out = torch.zeros_like(q)
        return (out, torch.zeros(q.shape[:2])) if return_lse else out

    monkeypatch.setattr(tattn, "fused_attention_reference", record)
    side = cfg.data.tile_size // 2 ** sum(isinstance(m, Downsample) for m in net.modules())
    channels = blocks[0].qkv.in_channels
    with torch.no_grad():
        blocks[0](torch.zeros(cfg.data.batch_size, channels, side, side), torch.float32)
    assert seen == [(6 * 16, 4096, 32)]

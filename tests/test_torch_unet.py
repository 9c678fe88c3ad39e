"""PyTorch port's UNet vs the JAX package's, and weights across the packages.

Tiny configs on the CPU: 16 px, 32 channels, mult (1, 2), attention at the
ds-2 level ("8") and in the mid block, 8-channel heads. Weights are made by
the flax init, jittered (ADM zero-inits the output convs, which would hide
faults), and carried to the port by ``unet_state_dict_from_flax``. JAX runs
in f32 with ``highest`` matmul precision; tolerance 3e-4 as in
``tests/test_compat.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stain2stain_tpu.compat import convert_lightning_state_dict, convert_unet_state_dict
from stain2stain_tpu.models import UNetModel as JaxUNet
from stain2stain_tpu_torch.compat import load_reference_checkpoint, unet_state_dict_from_flax
from stain2stain_tpu_torch.models import UNetModel
from tests.helpers.adm_torch import ADMUNet

TOL = 3e-4

TINY = dict(
    num_channels=32,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions="8",
    num_head_channels=8,
)


def _jittered_flax_params(net: JaxUNet, x: np.ndarray, y=None, seed: int = 0):
    t = jnp.zeros((x.shape[0],), jnp.float32)
    y = None if y is None else jnp.asarray(y)
    params = jax.jit(net.init)(jax.random.key(seed), t, jnp.asarray(x), y)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params
    )


def _pair(size: int = 16, class_cond: bool = False, **overrides):
    kw = dict(TINY, **overrides)
    if class_cond:
        kw.update(class_cond=True, num_classes=3)
    jnet = JaxUNet(dim=(3, size, size), fused_attention=False, dtype=jnp.float32, **kw)
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    y = np.array([0, 2], np.int32) if class_cond else None
    params = _jittered_flax_params(jnet, x, y)
    tnet = UNetModel(dim=(3, size, size), device="cpu", **kw).eval()
    sd = unet_state_dict_from_flax(
        params,
        image_size=size,
        num_channels=kw["num_channels"],
        num_res_blocks=kw["num_res_blocks"],
        channel_mult=kw["channel_mult"],
        attention_resolutions=kw["attention_resolutions"],
        num_head_channels=kw["num_head_channels"],
        class_cond=class_cond,
    )
    tnet.load_state_dict(sd, strict=True)
    return jnet, params, tnet, x, y


@pytest.mark.parametrize("class_cond", [False, True], ids=["plain", "class_cond"])
def test_unet_forward_matches_jax(class_cond):
    jnet, params, tnet, x, y = _pair(class_cond=class_cond)
    t = np.array([0.25, 0.8], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(
            jax.jit(jnet.apply)({"params": params}, jnp.asarray(t), jnp.asarray(x), None if y is None else jnp.asarray(y))
        )
    with torch.no_grad():
        got = tnet(torch.from_numpy(t), torch.from_numpy(x), None if y is None else torch.from_numpy(y).long())
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=TOL)


def test_unet_scalar_time_and_bf16_compute():
    _, _, tnet, x, _ = _pair()
    with torch.no_grad():
        a = tnet(torch.tensor(0.5), torch.from_numpy(x))
        b = tnet(torch.full((2,), 0.5), torch.from_numpy(x))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    bf = UNetModel(dim=(3, 16, 16), device="cpu", dtype="bfloat16", **TINY).eval()
    bf.load_state_dict(tnet.state_dict())
    with torch.no_grad():
        c = bf(torch.tensor(0.5), torch.from_numpy(x))
    assert c.dtype == torch.float32
    # bf16 compute rounds at every layer: the f32 result is the yardstick
    assert (c - a).abs().max() < 0.1 * a.abs().max() + 0.05


def _admunet(**kw) -> ADMUNet:
    torch.manual_seed(0)
    oracle = ADMUNet(image_size=16, **kw).eval()
    with torch.no_grad():
        for p in oracle.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return oracle


@pytest.mark.parametrize("class_cond", [False, True], ids=["plain", "class_cond"])
def test_weights_round_trip_bit_exact(class_cond):
    """ADMUNet state dict → JAX converter → port converter gives back every
    tensor bit for bit, and the port's UNet loads it strictly."""
    kw = dict(TINY)
    if class_cond:
        kw.update(class_cond=True, num_classes=3)
    oracle = _admunet(**kw)
    conv_kw = dict(
        image_size=16,
        num_channels=kw["num_channels"],
        num_res_blocks=kw["num_res_blocks"],
        channel_mult=kw["channel_mult"],
        attention_resolutions=kw["attention_resolutions"],
        num_head_channels=kw["num_head_channels"],
        class_cond=class_cond,
    )
    params = convert_unet_state_dict(oracle.state_dict(), **conv_kw)
    back = unet_state_dict_from_flax(params, **conv_kw)
    original = oracle.state_dict()
    assert set(back) == set(original)
    for key, value in original.items():
        assert back[key].shape == value.shape, key
        assert torch.equal(back[key], value), key
    net = UNetModel(dim=(3, 16, 16), device="cpu", **kw)
    net.load_state_dict(back, strict=True)
    assert set(net.state_dict()) == set(original)


def test_port_matches_reference_oracle_directly():
    """A reference (torchcfm-layout) state dict loads into the port unchanged
    and gives the oracle's forward."""
    oracle = _admunet(**TINY)
    net = UNetModel(dim=(3, 16, 16), device="cpu", **TINY).eval()
    net.load_state_dict(oracle.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, 16, 16)).astype(np.float32))
    t = torch.tensor([0.1, 0.9])
    with torch.no_grad():
        ref = oracle(t, x)
        got = net(t, x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_load_reference_checkpoint(tmp_path):
    oracle = _admunet(**TINY)
    sd = oracle.state_dict()
    torch.save(sd, tmp_path / "net.pt")
    torch.save({"state_dict": {f"net.{k}": v for k, v in sd.items()}, "epoch": 3}, tmp_path / "last.ckpt")
    for name in ("net.pt", "last.ckpt"):
        got = load_reference_checkpoint(tmp_path / name)
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd)
    # the JAX package's converter reads the same Lightning layout
    params = convert_lightning_state_dict(
        torch.load(tmp_path / "last.ckpt", weights_only=True)["state_dict"],
        image_size=16,
        num_channels=32,
        num_res_blocks=1,
        channel_mult=(1, 2),
        attention_resolutions="8",
        num_head_channels=8,
    )
    assert "mid" in params


@pytest.mark.parametrize("knob", [dict(use_checkpoint="blocks"), dict(fused_attention=False)])
def test_unported_knobs_raise(knob):
    """Knobs the port refuses: ``fused_attention=False`` would put the plain
    attention on the card's path; an unknown ``use_checkpoint`` value is
    refused as JAX refuses it."""
    err = ValueError if "use_checkpoint" in knob else NotImplementedError
    with pytest.raises(err):
        UNetModel(dim=(3, 16, 16), device="cpu", **TINY, **knob)


def test_resblock_updown_and_pool_resample_match_jax():
    for extra in (dict(resblock_updown=True), dict(conv_resample=False)):
        jnet, params, tnet, x, _ = _pair(**extra)
        t = np.array([0.3, 0.6], np.float32)
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(t), jnp.asarray(x)))
        with torch.no_grad():
            got = tnet(torch.from_numpy(t), torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


# ---- fused_conv=True: ResBlocks through ops/conv.norm_act_conv (K2–K5 on the card)

FUSED_TINY = dict(
    num_channels=128,
    num_res_blocks=1,
    channel_mult=(1, 2),
    attention_resolutions="16",
    num_head_channels=32,
    resblock_updown=True,  # the down and up ResBlocks are gated off the fused path
)


def _jittered(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Every parameter jittered: ADM zero-inits the output convs, which would
    make a faulty second conv invisible."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return net


def _count_fused(monkeypatch) -> list:
    from stain2stain_tpu_torch.ops import conv as conv_ops

    calls = [0]
    real = conv_ops.norm_act_conv

    def counting(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(conv_ops, "norm_act_conv", counting)
    return calls


def test_fused_conv_keeps_the_state_dict_keys():
    plain = UNetModel(dim=(3, 32, 32), device="cpu", **FUSED_TINY)
    fused = UNetModel(dim=(3, 32, 32), device="cpu", fused_conv=True, **FUSED_TINY)
    assert list(plain.state_dict()) == list(fused.state_dict())
    assert all(plain.state_dict()[k].shape == v.shape for k, v in fused.state_dict().items())
    fused.load_state_dict(plain.state_dict(), strict=True)


def test_fused_conv_unet_matches_unfused(monkeypatch):
    """bf16 forward of the fused net against the unfused port net with the
    same weights. 8 of the 10 ResBlocks pass the gate (the down and up blocks
    do not), so ``norm_act_conv`` runs 16 times. Tolerance: both nets round
    to bf16 at every layer but at other points (the fused conv adds its bias
    in f32 before rounding), so they differ by a few bf16 ulps (2^-8 relative)
    compounded over about 20 layers: 3e-2 × max|out| + 1e-2."""
    plain = _jittered(UNetModel(dim=(3, 32, 32), device="cpu", dtype="bfloat16", **FUSED_TINY)).eval()
    fused = UNetModel(dim=(3, 32, 32), device="cpu", dtype="bfloat16", fused_conv=True, **FUSED_TINY).eval()
    fused.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32))
    t = torch.tensor([0.2, 0.7])
    calls = _count_fused(monkeypatch)
    with torch.no_grad():
        got = fused(t, x)
        assert calls[0] == 16
        want = plain(t, x)
    assert calls[0] == 16 and got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 3e-2 * want.abs().max().item() + 1e-2, err


def test_fused_conv_gate():
    from stain2stain_tpu_torch.models.unet import ResBlock

    block = ResBlock(128, 512, 128, dropout=0.1, fused_conv=True)
    x = torch.zeros(2, 128, 16, 16)
    assert block.fused_enabled(x, torch.bfloat16)
    assert not block.fused_enabled(x, torch.float32)  # bf16 compute only
    assert not block.fused_enabled(torch.zeros(2, 128, 16, 8), torch.bfloat16)  # W % 16
    assert not block.fused_enabled(torch.zeros(2, 96, 16, 16), torch.bfloat16)  # C % 128
    assert not ResBlock(128, 512, 64, fused_conv=True).fused_enabled(x, torch.bfloat16)  # D % 128
    assert not ResBlock(128, 512, 128, down=True, fused_conv=True).fused_enabled(x, torch.bfloat16)
    assert not ResBlock(128, 512, 128, use_scale_shift_norm=False, fused_conv=True).fused_enabled(
        x, torch.bfloat16
    )
    assert not ResBlock(128, 512, 128).fused_enabled(x, torch.bfloat16)


@pytest.mark.parametrize("in_ch", [128, 256], ids=["identity_skip", "conv_skip"])
def test_fused_resblock_drops_the_units_the_unfused_one_drops(in_ch):
    """Dropout 0.3 in training mode, one generator seed for both blocks: the
    fused block's hash mask (K2, K4, K5) and the unfused ``FastDropout`` mask
    are the same function of the NHWC element index and seed, so outputs and
    every gradient agree within bf16 rounding. Were other units dropped, the
    outputs would differ by O(1). Tolerance: 3e-2 × max|ref| (the unfused
    path rounds n to bf16 before the mask and scales by bf16(1/0.7), the fused
    one after it, in f32)."""
    from stain2stain_tpu_torch.models.unet import ResBlock

    torch.manual_seed(0)
    blocks = {f: ResBlock(in_ch, 512, 128, dropout=0.3, fused_conv=f).train() for f in (False, True)}
    _jittered(blocks[False], seed=1)
    blocks[True].load_state_dict(blocks[False].state_dict())
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((2, in_ch, 16, 16)).astype(np.float32)).to(torch.bfloat16)
    emb = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 128, 16, 16)).astype(np.float32)).to(torch.bfloat16)
    out, grads = {}, {}
    for fused, block in blocks.items():
        assert block.fused_enabled(x0, torch.bfloat16) == fused
        x = x0.clone().requires_grad_()
        y = block(x, emb, torch.bfloat16, torch.Generator().manual_seed(9))
        y.backward(dy)
        out[fused] = y.detach().float()
        grads[fused] = {"x": x.grad.float(), **{n: p.grad.float() for n, p in block.named_parameters()}}
    ref = out[False]
    assert (out[True] - ref).abs().max() <= 3e-2 * ref.abs().max()
    assert set(grads[True]) == set(grads[False])
    for name, g in grads[False].items():
        assert (grads[True][name] - g).abs().max() <= 3e-2 * g.abs().max() + 1e-6, name
    # another seed drops other units: the outputs move by far more than rounding
    other = blocks[True](x0, emb, torch.bfloat16, torch.Generator().manual_seed(10)).float()
    assert (other - ref).abs().max() > 0.2 * ref.abs().max()

"""InceptionV3 pool3 feature extractor for FID (counterpart of
``stain2stain_tpu/ops/inception.py``), NCHW torch convolutions.

- The torchvision ``inception_v3`` topology up to the 2048-d global average
  pool (no aux head, no fc), BatchNorm folded into the convolutions at load.
- The pytorch-fid pooling variants (``fid_variant=True``, default): the
  branch-pool average pools leave the padding out of the count, and
  Mixed_7c's branch pool is a max pool.
- Input (B, H, W, 3) in [0, 1], resized to 299² bilinear (with antialiasing
  when shrinking, as ``jax.image.resize``) and scaled to [-1, 1].

Parameters are the JAX package's: ``{layer: (w_hwio, bias)}``, f32, so one
dict serves both. Weights are not bundled: :func:`load_params` reads the
BN-folded npz that ``scripts/convert_inception_weights.py`` writes, found
through ``S2S_INCEPTION_WEIGHTS`` or ``<repo>/weights/inception_v3_fid.npz``.
On the card the convolutions run in full f32 (no TF32), as JAX runs them at
``Precision.HIGHEST``: FID features must not carry TF32's rounding. This
network was never a Pallas kernel; it is plain PyTorch.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

BN_EPS = 1e-3  # torchvision BatchNorm2d eps for inception_v3

# name -> (out_ch, in_ch, kh, kw): the conv inventory of torchvision's
# inception_v3 feature path
_STEM = {
    "Conv2d_1a_3x3": (32, 3, 3, 3),
    "Conv2d_2a_3x3": (32, 32, 3, 3),
    "Conv2d_2b_3x3": (64, 32, 3, 3),
    "Conv2d_3b_1x1": (80, 64, 1, 1),
    "Conv2d_4a_3x3": (192, 80, 3, 3),
}


def _block_a(pre: str, in_ch: int, pool_features: int) -> dict:
    return {
        f"{pre}.branch1x1": (64, in_ch, 1, 1),
        f"{pre}.branch5x5_1": (48, in_ch, 1, 1),
        f"{pre}.branch5x5_2": (64, 48, 5, 5),
        f"{pre}.branch3x3dbl_1": (64, in_ch, 1, 1),
        f"{pre}.branch3x3dbl_2": (96, 64, 3, 3),
        f"{pre}.branch3x3dbl_3": (96, 96, 3, 3),
        f"{pre}.branch_pool": (pool_features, in_ch, 1, 1),
    }


def _block_b(pre: str, in_ch: int) -> dict:
    return {
        f"{pre}.branch3x3": (384, in_ch, 3, 3),
        f"{pre}.branch3x3dbl_1": (64, in_ch, 1, 1),
        f"{pre}.branch3x3dbl_2": (96, 64, 3, 3),
        f"{pre}.branch3x3dbl_3": (96, 96, 3, 3),
    }


def _block_c(pre: str, in_ch: int, c7: int) -> dict:
    return {
        f"{pre}.branch1x1": (192, in_ch, 1, 1),
        f"{pre}.branch7x7_1": (c7, in_ch, 1, 1),
        f"{pre}.branch7x7_2": (c7, c7, 1, 7),
        f"{pre}.branch7x7_3": (192, c7, 7, 1),
        f"{pre}.branch7x7dbl_1": (c7, in_ch, 1, 1),
        f"{pre}.branch7x7dbl_2": (c7, c7, 7, 1),
        f"{pre}.branch7x7dbl_3": (c7, c7, 1, 7),
        f"{pre}.branch7x7dbl_4": (c7, c7, 7, 1),
        f"{pre}.branch7x7dbl_5": (192, c7, 1, 7),
        f"{pre}.branch_pool": (192, in_ch, 1, 1),
    }


def _block_d(pre: str, in_ch: int) -> dict:
    return {
        f"{pre}.branch3x3_1": (192, in_ch, 1, 1),
        f"{pre}.branch3x3_2": (320, 192, 3, 3),
        f"{pre}.branch7x7x3_1": (192, in_ch, 1, 1),
        f"{pre}.branch7x7x3_2": (192, 192, 1, 7),
        f"{pre}.branch7x7x3_3": (192, 192, 7, 1),
        f"{pre}.branch7x7x3_4": (192, 192, 3, 3),
    }


def _block_e(pre: str, in_ch: int) -> dict:
    return {
        f"{pre}.branch1x1": (320, in_ch, 1, 1),
        f"{pre}.branch3x3_1": (384, in_ch, 1, 1),
        f"{pre}.branch3x3_2a": (384, 384, 1, 3),
        f"{pre}.branch3x3_2b": (384, 384, 3, 1),
        f"{pre}.branch3x3dbl_1": (448, in_ch, 1, 1),
        f"{pre}.branch3x3dbl_2": (384, 448, 3, 3),
        f"{pre}.branch3x3dbl_3a": (384, 384, 1, 3),
        f"{pre}.branch3x3dbl_3b": (384, 384, 3, 1),
        f"{pre}.branch_pool": (192, in_ch, 1, 1),
    }


CONV_SPECS: dict = {
    **_STEM,
    **_block_a("Mixed_5b", 192, 32),
    **_block_a("Mixed_5c", 256, 64),
    **_block_a("Mixed_5d", 288, 64),
    **_block_b("Mixed_6a", 288),
    **_block_c("Mixed_6b", 768, 128),
    **_block_c("Mixed_6c", 768, 160),
    **_block_c("Mixed_6d", 768, 160),
    **_block_c("Mixed_6e", 768, 192),
    **_block_d("Mixed_7a", 768),
    **_block_e("Mixed_7b", 1280),
    **_block_e("Mixed_7c", 2048),
}

FEATURE_DIM = 2048


def default_weights_path() -> Path:
    env = os.environ.get("S2S_INCEPTION_WEIGHTS")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "weights" / "inception_v3_fid.npz"


def weights_available() -> bool:
    return default_weights_path().exists()


def _to_params(arrays: dict, device: DeviceLike) -> dict:
    dev = resolve_device(device)
    return {name: (torch.as_tensor(np.asarray(w, np.float32), device=dev),
                   torch.as_tensor(np.asarray(b, np.float32), device=dev)) for name, (w, b) in arrays.items()}


def load_params(path: Optional[str] = None, device: DeviceLike = None) -> dict:
    """A converted npz (torch state-dict names) with BN folded into the convs:
    ``{layer: (w_hwio, bias)}`` f32 on ``device``. Shapes are checked against
    :data:`CONV_SPECS`, so a wrong or partial file fails loudly."""
    p = Path(path) if path else default_weights_path()
    raw = np.load(str(p))
    params = {}
    for name, (out_ch, in_ch, kh, kw) in CONV_SPECS.items():
        try:
            w = raw[f"{name}.conv.weight"]
            gamma = raw[f"{name}.bn.weight"]
            beta = raw[f"{name}.bn.bias"]
            mean = raw[f"{name}.bn.running_mean"]
            var = raw[f"{name}.bn.running_var"]
        except KeyError as e:
            raise ValueError(f"{p}: missing key for layer {name}: {e}") from e
        if tuple(w.shape) != (out_ch, in_ch, kh, kw):
            raise ValueError(
                f"{p}: {name}.conv.weight has shape {tuple(w.shape)}, expected {(out_ch, in_ch, kh, kw)} (OIHW)"
            )
        scale = gamma / np.sqrt(var + BN_EPS)
        w_hwio = np.transpose(w, (2, 3, 1, 0)).astype(np.float32) * scale.astype(np.float32)
        params[name] = (w_hwio, (beta - mean * scale).astype(np.float32))
    return _to_params(params, device)


def init_params(seed: int = 0, scale: float = 0.05, device: DeviceLike = None) -> dict:
    """Random weights with the architecture's shapes (tests, smoke runs), drawn
    from numpy's ``default_rng(seed)`` in sorted layer order."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (out_ch, in_ch, kh, kw) in sorted(CONV_SPECS.items()):
        w = rng.standard_normal((kh, kw, in_ch, out_ch), dtype=np.float32) * np.float32(scale)
        params[name] = (w, np.zeros((out_ch,), np.float32))
    return _to_params(params, device)


@contextmanager
def full_f32_convs():
    """cuDNN convolutions in full f32 inside the block (TF32 off), as JAX's
    ``Precision.HIGHEST``; the setting is restored after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


# --------------------------------------------------------------------- forward
def _conv(params, name, x, stride=1, padding=0):
    w, b = params[name]
    if isinstance(padding, int):
        padding = (padding, padding)
    return F.relu(F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride, padding=padding))


def _max_pool(x, window=3, stride=2, padding=0):
    return F.max_pool2d(x, window, stride, padding)


def _avg_pool3(x, count_include_pad: bool):
    """3×3 stride-1 pad-1 average pool (the inception branch pool)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


def _inception_a(p, pre, x, fid_variant):
    b1 = _conv(p, f"{pre}.branch1x1", x)
    b5 = _conv(p, f"{pre}.branch5x5_2", _conv(p, f"{pre}.branch5x5_1", x), padding=2)
    b3 = _conv(p, f"{pre}.branch3x3dbl_1", x)
    b3 = _conv(p, f"{pre}.branch3x3dbl_2", b3, padding=1)
    b3 = _conv(p, f"{pre}.branch3x3dbl_3", b3, padding=1)
    bp = _conv(p, f"{pre}.branch_pool", _avg_pool3(x, count_include_pad=not fid_variant))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b(p, pre, x):
    b3 = _conv(p, f"{pre}.branch3x3", x, stride=2)
    bd = _conv(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv(p, f"{pre}.branch3x3dbl_2", bd, padding=1)
    bd = _conv(p, f"{pre}.branch3x3dbl_3", bd, stride=2)
    return torch.cat([b3, bd, _max_pool(x)], dim=1)


def _inception_c(p, pre, x, fid_variant):
    b1 = _conv(p, f"{pre}.branch1x1", x)
    b7 = _conv(p, f"{pre}.branch7x7_1", x)
    b7 = _conv(p, f"{pre}.branch7x7_2", b7, padding=(0, 3))
    b7 = _conv(p, f"{pre}.branch7x7_3", b7, padding=(3, 0))
    bd = _conv(p, f"{pre}.branch7x7dbl_1", x)
    bd = _conv(p, f"{pre}.branch7x7dbl_2", bd, padding=(3, 0))
    bd = _conv(p, f"{pre}.branch7x7dbl_3", bd, padding=(0, 3))
    bd = _conv(p, f"{pre}.branch7x7dbl_4", bd, padding=(3, 0))
    bd = _conv(p, f"{pre}.branch7x7dbl_5", bd, padding=(0, 3))
    bp = _conv(p, f"{pre}.branch_pool", _avg_pool3(x, count_include_pad=not fid_variant))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d(p, pre, x):
    b3 = _conv(p, f"{pre}.branch3x3_2", _conv(p, f"{pre}.branch3x3_1", x), stride=2)
    b7 = _conv(p, f"{pre}.branch7x7x3_1", x)
    b7 = _conv(p, f"{pre}.branch7x7x3_2", b7, padding=(0, 3))
    b7 = _conv(p, f"{pre}.branch7x7x3_3", b7, padding=(3, 0))
    b7 = _conv(p, f"{pre}.branch7x7x3_4", b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], dim=1)


def _inception_e(p, pre, x, fid_variant, pool: str):
    b1 = _conv(p, f"{pre}.branch1x1", x)
    b3 = _conv(p, f"{pre}.branch3x3_1", x)
    b3 = torch.cat([_conv(p, f"{pre}.branch3x3_2a", b3, padding=(0, 1)),
                    _conv(p, f"{pre}.branch3x3_2b", b3, padding=(1, 0))], dim=1)
    bd = _conv(p, f"{pre}.branch3x3dbl_1", x)
    bd = _conv(p, f"{pre}.branch3x3dbl_2", bd, padding=1)
    bd = torch.cat([_conv(p, f"{pre}.branch3x3dbl_3a", bd, padding=(0, 1)),
                    _conv(p, f"{pre}.branch3x3dbl_3b", bd, padding=(1, 0))], dim=1)
    if pool == "max":  # pytorch-fid's FIDInceptionE_2 (Mixed_7c)
        bp = _max_pool(x, window=3, stride=1, padding=1)
    else:
        bp = _avg_pool3(x, count_include_pad=not fid_variant)
    return torch.cat([b1, b3, bd, _conv(p, f"{pre}.branch_pool", bp)], dim=1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW bilinear resize to 299² with half-pixel centres; antialiased when
    shrinking, as ``jax.image.resize(..., "bilinear")``."""
    shrink = x.shape[2] > 299 or x.shape[3] > 299
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=shrink)


def pool3_features(params: dict, images: torch.Tensor, fid_variant: bool = True, resize: bool = True) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] → (B, 2048) pool3 features, on the
    images' device (full f32 convolutions on the card)."""
    x = torch.as_tensor(images).to(torch.float32).permute(0, 3, 1, 2)
    with full_f32_convs(), torch.no_grad():
        if resize and tuple(x.shape[2:]) != (299, 299):
            x = resize_299(x)
        x = x * 2.0 - 1.0  # pytorch-fid normalize_input
        x = _conv(params, "Conv2d_1a_3x3", x, stride=2)
        x = _conv(params, "Conv2d_2a_3x3", x)
        x = _conv(params, "Conv2d_2b_3x3", x, padding=1)
        x = _max_pool(x)
        x = _conv(params, "Conv2d_3b_1x1", x)
        x = _conv(params, "Conv2d_4a_3x3", x)
        x = _max_pool(x)
        x = _inception_a(params, "Mixed_5b", x, fid_variant)
        x = _inception_a(params, "Mixed_5c", x, fid_variant)
        x = _inception_a(params, "Mixed_5d", x, fid_variant)
        x = _inception_b(params, "Mixed_6a", x)
        x = _inception_c(params, "Mixed_6b", x, fid_variant)
        x = _inception_c(params, "Mixed_6c", x, fid_variant)
        x = _inception_c(params, "Mixed_6d", x, fid_variant)
        x = _inception_c(params, "Mixed_6e", x, fid_variant)
        x = _inception_d(params, "Mixed_7a", x)
        x = _inception_e(params, "Mixed_7b", x, fid_variant, pool="avg")
        x = _inception_e(params, "Mixed_7c", x, fid_variant, pool="max" if fid_variant else "avg")
        return x.mean(dim=(2, 3))  # adaptive average pool → (B, 2048)


__all__ = [
    "CONV_SPECS",
    "FEATURE_DIM",
    "BN_EPS",
    "default_weights_path",
    "weights_available",
    "load_params",
    "init_params",
    "pool3_features",
    "resize_299",
    "full_f32_convs",
]

"""Image-quality metrics: PSNR, SSIM, FID (counterpart of
``stain2stain_tpu/ops/metrics.py``).

- :func:`psnr`: peak signal-to-noise over [0, 1] images.
- :func:`ssim`: single-scale SSIM (Wang et al. 2004), 11×11 Gaussian window
  σ 1.5, C1 = (0.01·L)², C2 = (0.03·L)², a VALID depthwise filter. Its
  variance terms (E[x²] − μ²) cancel catastrophically in low precision, so
  on the card the filter runs in full f32 (no TF32), as JAX pins
  ``Precision.HIGHEST``.
- :func:`fid`: the Fréchet distance between Gaussian fits of two feature
  sets (scipy ``sqrtm``). Features come from :class:`FeatureExtractor`:
  InceptionV3 pool3 when converted weights exist, else a fixed-seed
  random-feature CNN whose FIDs compare only with each other.

The random CNN's weights are drawn from numpy's ``default_rng(seed)`` with
JAX's shapes and He scale; JAX draws its own from ``jax.random``, which
torch cannot reproduce. Its name (``random_cnn_np_<dim>_seed<seed>``) differs
from JAX's so that nobody compares the two FIDs; ``fid_comparable`` stays
false for both.
"""

from __future__ import annotations

import math
import sys
import zipfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from .image import denormalize
from .inception import full_f32_convs


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean PSNR (dB) over the batch; inputs (B, H, W, C) in [0, max_val]."""
    mse = torch.mean(torch.square(pred.to(torch.float32) - target.to(torch.float32)), dim=(1, 2, 3))
    return torch.mean(10.0 * torch.log10((max_val * max_val) / torch.clamp(mse, min=1e-12)))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def _depthwise_filter(x: torch.Tensor, kernel2d: torch.Tensor) -> torch.Tensor:
    """VALID depthwise 2-D filter of NCHW ``x``, in full f32."""
    c = x.shape[1]
    weight = kernel2d[None, None].expand(c, 1, *kernel2d.shape).contiguous()
    with full_f32_convs():
        return F.conv2d(x, weight, groups=c)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over batch and channels; inputs (B, H, W, C) in [0, max_val]."""
    x = pred.to(torch.float32).permute(0, 3, 1, 2)
    y = target.to(torch.float32).permute(0, 3, 1, 2)
    kernel = _gaussian_kernel(kernel_size, sigma, x.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _depthwise_filter(x, kernel)
    mu_y = _depthwise_filter(y, kernel)
    mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x2 = _depthwise_filter(x * x, kernel) - mu_x2
    sigma_y2 = _depthwise_filter(y * y, kernel) - mu_y2
    sigma_xy = _depthwise_filter(x * y, kernel) - mu_xy
    ssim_map = ((2.0 * mu_xy + c1) * (2.0 * sigma_xy + c2)) / ((mu_x2 + mu_y2 + c1) * (sigma_x2 + sigma_y2 + c2))
    return torch.mean(ssim_map)


# ------------------------------------------------------------------------- FID
def _same_pads(size: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: the odd pixel goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _random_cnn(x: torch.Tensor, params: list) -> torch.Tensor:
    """The random-feature CNN: four stride-2 3×3 SAME convs (HWIO weights),
    leaky ReLU 0.2, global mean pool; (B, H, W, C) → (B, D)."""
    h = x.to(torch.float32).permute(0, 3, 1, 2)
    with full_f32_convs():
        for w in params:
            top, bottom = _same_pads(h.shape[2])
            left, right = _same_pads(h.shape[3])
            h = F.conv2d(F.pad(h, (left, right, top, bottom)), w.permute(3, 2, 0, 1), stride=2)
            h = F.leaky_relu(h, 0.2)
    return h.mean(dim=(2, 3))


class FeatureExtractor:
    """Images → feature vectors for FID, computed on ``device``.

    ``kind="auto"``: InceptionV3 pool3 (2048-d, :mod:`.inception`) when
    converted weights are present (``S2S_INCEPTION_WEIGHTS`` or
    ``<repo>/weights/inception_v3_fid.npz``), else the fixed-seed random
    CNN (``feature_dim``-d). ``kind="inception"`` raises without weights;
    ``kind="random"`` always takes the random CNN.
    """

    def __init__(self, kind: str = "auto", feature_dim: int = 512, seed: int = 0,
                 weights_path: Optional[str] = None, device: DeviceLike = None):
        if kind not in ("auto", "inception", "random"):
            raise ValueError(f"unknown feature-extractor kind {kind!r}: expected 'auto', 'inception', or 'random'")
        self.kind = kind
        self.feature_dim = feature_dim
        self.seed = seed
        self.device = resolve_device(device)
        self.random_params: Optional[list] = None  # HWIO weights, made at the first call
        self._inception_params = None
        if kind in ("auto", "inception"):
            self._inception_params = self._try_inception(weights_path)
            if self._inception_params is None and kind == "inception":
                raise RuntimeError(
                    "InceptionV3 weights unavailable — convert them with "
                    "scripts/convert_inception_weights.py and set S2S_INCEPTION_WEIGHTS"
                )
        self.name = (
            "inception_v3_fid" if self._inception_params is not None
            else f"random_cnn_np_{feature_dim}_seed{seed}"
        )

    def _try_inception(self, weights_path=None):
        from . import inception

        try:
            if weights_path is not None:
                return inception.load_params(weights_path, device=self.device)
            if inception.weights_available():
                return inception.load_params(device=self.device)
        except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile) as e:  # corrupt or mismatched file: fall back loudly
            import warnings

            warnings.warn(f"InceptionV3 weights failed to load ({e}); using random-feature FID")
        return None

    def _random_weights(self, in_ch: int) -> list:
        rng = np.random.default_rng(self.seed)
        chans = [in_ch, 64, 128, 256, self.feature_dim]
        return [
            torch.from_numpy(rng.standard_normal((3, 3, chans[i], chans[i + 1]), dtype=np.float32)
                             * np.float32(math.sqrt(2.0 / (9 * chans[i])))).to(self.device)
            for i in range(4)
        ]

    def __call__(self, images) -> np.ndarray:
        """images: (B, H, W, 3) in [0, 1] → (B, D) float64 features."""
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images)
        x = x.to(self.device, torch.float32)
        with torch.no_grad():
            if self._inception_params is not None:
                from .inception import pool3_features

                feats = pool3_features(self._inception_params, x)
            else:
                if self.random_params is None:
                    self.random_params = self._random_weights(x.shape[-1])
                feats = _random_cnn(x, self.random_params)
        return feats.cpu().numpy().astype(np.float64)


def fid_from_stats(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians. As pytorch-fid: if sqrtm of the
    (often rank-deficient) product is not finite, retry with ``eps`` on the
    covariance diagonals."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def fid(real, generated, extractor: Optional[Callable] = None) -> float:
    """FID between two image sets (N, H, W, 3) in [0, 1]."""
    extractor = extractor or FeatureExtractor()
    f_real = np.asarray(extractor(real))
    f_gen = np.asarray(extractor(generated))
    eps = 1e-6 * np.eye(f_real.shape[1])
    mu1, s1 = f_real.mean(0), np.cov(f_real, rowvar=False) + eps
    mu2, s2 = f_gen.mean(0), np.cov(f_gen, rowvar=False) + eps
    return fid_from_stats(mu1, s1, mu2, s2)


def evaluate_quality(task, loader, num_steps: int = 50, max_batches: Optional[int] = None,
                     extractor: Optional[Callable] = None) -> dict:
    """Translate the loader's tiles with ``task.generate`` and score SSIM and
    PSNR against the targets (example-weighted means over the batches) and FID
    over the whole translated set."""
    ssim_vals, psnr_vals = [], []
    gen_all, tgt_all = [], []
    for i, batch in enumerate(loader):
        if max_batches is not None and i >= max_batches:
            break
        prepared = task.prepare_batch(task.device_fields(batch), train=False)
        src, tgt = prepared[0], prepared[1]
        gen01, tgt01 = denormalize(task.generate(src, num_steps=num_steps)), denormalize(tgt)
        ssim_vals.append(float(ssim(gen01, tgt01)))
        psnr_vals.append(float(psnr(gen01, tgt01)))
        gen_all.append(gen01.cpu().numpy())
        tgt_all.append(tgt01.cpu().numpy())
    if not gen_all:
        raise ValueError("evaluate_quality saw no batches (empty loader or max_batches=0)")
    # example-weighted means: a ragged final batch counts by its size
    weights = np.array([g.shape[0] for g in gen_all], np.float64)
    out = {
        "ssim": float(np.average(ssim_vals, weights=weights)),
        "psnr": float(np.average(psnr_vals, weights=weights)),
    }
    gen_np, tgt_np = np.concatenate(gen_all), np.concatenate(tgt_all)
    if len(gen_np) >= 2:
        ext = extractor or FeatureExtractor(device=task.device)
        out["fid"] = fid(tgt_np, gen_np, ext)
        ext_name = getattr(ext, "name", "custom")
        out["fid_extractor"] = ext_name
        out["fid_comparable"] = ext_name == "inception_v3_fid"
        if not out["fid_comparable"]:
            print(
                "=" * 70
                + f"\nWARNING: FID computed with the fallback feature extractor ({ext_name}).\n"
                "This number is NOT comparable to published Inception-FID values.\n"
                "Convert real InceptionV3 weights with scripts/convert_inception_weights.py\n"
                "and set S2S_INCEPTION_WEIGHTS to get comparable FIDs.\n" + "=" * 70,
                file=sys.stderr,
            )
    return out


__all__ = ["psnr", "ssim", "fid", "fid_from_stats", "FeatureExtractor", "evaluate_quality"]

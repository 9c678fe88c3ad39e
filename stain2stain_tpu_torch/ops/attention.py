"""Multi-head self-attention of the UNet, with kernel K1-fwd on the card.

Counterpart of ``stain2stain_tpu/ops/pallas_attention.py``. The TPU kernel
(``_fwd_kernel``) becomes ``csrc/attention_fwd.cu``, a CUDA C++ kernel for
``sm_90a`` built by ``nvcc`` at first use and called through ctypes (see the
source note there for its bound and design).

- :func:`attention` takes (B, T, H, d) q/k/v, folds them to (B·H, T, d) for
  :func:`fused_attention` on a CUDA tensor, and takes the plain einsum path
  :func:`attention_reference` on a CPU tensor.
- :func:`fused_attention` launches K1 on CUDA tensors and raises on anything
  the kernel does not take; on CPU tensors it runs the kernel's plain version
  :func:`fused_attention_reference`. ``fused_attention.launches`` counts the
  kernel launches (a plain integer), so a run can show that it went through
  the kernel.

Only the forward exists in this slice; the backward kernel comes with
training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCE = "attention_fwd.cu"


def _kernel():
    lib = _build.load(_SOURCE)
    fn = lib.s2s_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K1-fwd on (BH, T, d): f32 q·kᵀ·scale, softmax, ·v."""
    s = torch.matmul(q.to(torch.float32) * scale, k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def _check(q, k, v) -> None:
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"fused_attention expects equal (BH, T, d) q/k/v, got {q.shape}, {k.shape}, {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention takes float32 or bfloat16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention needs contiguous (BH, T, d) tensors")
    bh, t, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"fused_attention supports head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if bh * math.ceil(t / 64) >= 2**31:
        raise ValueError(f"fused_attention grid too large for BH={bh}, T={t}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(BH, T, d) q/k/v → (BH, T, d) softmax(q·kᵀ·scale)·v in q's dtype."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return fused_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, got {q.device}")
    _check(q, k, v)
    bh, t, d = q.shape
    out = torch.empty_like(q)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bh, t, d, _DTYPE_CODES[q.dtype], float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel launch failed: cudaError {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def attention_reference(q, k, v, head_dim: int) -> torch.Tensor:
    """Plain einsum path on (B, T, H, d), f32 logits (``pallas_attention.py:207-213``)."""
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale, k.to(torch.float32))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(torch.float32))
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Multi-head attention (B, T, H, d) → (B, T, H, d), total scale 1/√d.

    CUDA tensors go through K1 (folded to (B·H, T, d)); CPU tensors through
    :func:`attention_reference`.
    """
    if q.device.type == "cpu":
        return attention_reference(q, k, v, head_dim)
    batch, t, heads, d = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(batch * heads, t, d).contiguous()

    out = fused_attention(fold(q), fold(k), fold(v), 1.0 / math.sqrt(head_dim))
    return out.reshape(batch, heads, t, d).permute(0, 2, 1, 3)


__all__ = [
    "attention",
    "attention_reference",
    "fused_attention",
    "fused_attention_reference",
    "SUPPORTED_HEAD_DIMS",
]

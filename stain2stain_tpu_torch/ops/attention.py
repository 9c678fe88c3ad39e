"""Multi-head self-attention of the UNet, with kernels K1-fwd and K1-bwd on the card.

Counterpart of ``stain2stain_tpu/ops/pallas_attention.py``. The TPU kernels
become CUDA C++ for ``sm_90a``, built by ``nvcc`` at first use and called
through ctypes (see the source notes for their bounds and designs):

- ``_fwd_kernel`` → ``csrc/attention_fwd.cu`` (:func:`fused_attention`);
- ``_bwd_kernel`` → ``csrc/attention_bwd.cu`` (:func:`fused_attention_backward`).

:class:`FusedAttention` is the ``torch.autograd.Function`` in place of the
JAX ``custom_vjp``: its forward is K1-fwd and saves (q, k, v, o) as the JAX
VJP does (``pallas_attention.py:147-149``); its backward is K1-bwd, which
recomputes the softmax statistics rather than saving them.

Each wrapper launches its kernel on CUDA tensors and raises on anything the
kernel does not take; on CPU tensors it runs the kernel's plain version
(:func:`fused_attention_reference`, :func:`fused_attention_backward_reference`).
``fused_attention.launches`` and ``fused_attention_backward.launches`` count
the kernel launches (plain integers), so a run can show that it went through
the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build

SUPPORTED_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _kernel():
    lib = _build.load("attention_fwd.cu")
    fn = lib.s2s_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel():
    lib = _build.load("attention_bwd.cu")
    fn = lib.s2s_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """Plain version of K1-fwd on (BH, T, d): f32 q·kᵀ·scale, softmax, ·v."""
    s = torch.matmul(q.to(torch.float32) * scale, k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def fused_attention_backward_reference(q, k, v, o, do, scale: float):
    """Plain version of K1-bwd on (BH, T, d): the flash identities of
    ``pallas_attention.py:85-105`` in f32, softmax statistics recomputed.

    Returns (dq, dk, dv) in the inputs' dtype.
    """
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    of, dof = o.to(torch.float32), do.to(torch.float32)
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(*tensors) -> None:
    """Raise on (BH, T, d) tensors the kernels do not take."""
    first = tensors[0]
    if first.dim() != 3 or any(t.shape != first.shape for t in tensors):
        raise ValueError(f"fused_attention expects equal (BH, T, d) tensors, got {[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != first.dtype for t in tensors) or first.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention takes float32 or bfloat16 tensors, got {[t.dtype for t in tensors]}")
    if any(t.device != first.device for t in tensors):
        raise ValueError("fused_attention's tensors must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_attention needs contiguous (BH, T, d) tensors")
    bh, t, d = first.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"fused_attention supports head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if bh * math.ceil(t / 64) >= 2**31:
        raise ValueError(f"fused_attention grid too large for BH={bh}, T={t}")


def _on_cpu(*tensors) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if tensors[0].device.type != "cuda":
        raise ValueError(f"fused_attention runs on CUDA or CPU tensors, got {tensors[0].device}")
    return False


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """(BH, T, d) q/k/v → (BH, T, d) softmax(q·kᵀ·scale)·v in q's dtype (K1-fwd)."""
    if _on_cpu(q, k, v):
        return fused_attention_reference(q, k, v, scale)
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


def fused_attention_backward(q, k, v, o, do, scale: float):
    """(BH, T, d) q, k, v, o, do → (dq, dk, dv) in the inputs' dtype (K1-bwd)."""
    if _on_cpu(q, k, v, o, do):
        return fused_attention_backward_reference(q, k, v, o, do, scale)
    _check(q, k, v, o, do)
    bh, t, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per-row log-sum-exp and rowsum(do∘o): the kernel's only scratch
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            bh, t, d, _DTYPE_CODES[q.dtype], float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: cudaError {err}")
    fused_attention_backward.launches += 1
    return dq, dk, dv


fused_attention_backward.launches = 0


class FusedAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale)·v on (BH, T, d) with K1-fwd forward and K1-bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out = fused_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, out, do.contiguous(), ctx.scale)
        return dq, dk, dv, None


def attention_reference(q, k, v, head_dim: int) -> torch.Tensor:
    """Plain einsum path on (B, T, H, d), f32 logits (``pallas_attention.py:207-213``)."""
    scale = 1.0 / math.sqrt(head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32) * scale, k.to(torch.float32))
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.to(torch.float32))
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Multi-head attention (B, T, H, d) → (B, T, H, d), total scale 1/√d.

    Folds to (B·H, T, d) and goes through :class:`FusedAttention`: K1-fwd and
    K1-bwd on CUDA tensors, their plain versions on CPU tensors.
    """
    batch, t, heads, d = q.shape

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(batch * heads, t, d).contiguous()

    out = FusedAttention.apply(fold(q), fold(k), fold(v), 1.0 / math.sqrt(head_dim))
    return out.reshape(batch, heads, t, d).permute(0, 2, 1, 3)


__all__ = [
    "attention",
    "attention_reference",
    "FusedAttention",
    "fused_attention",
    "fused_attention_backward",
    "fused_attention_backward_reference",
    "fused_attention_reference",
    "SUPPORTED_HEAD_DIMS",
]

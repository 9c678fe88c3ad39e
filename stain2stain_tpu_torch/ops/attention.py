"""Multi-head self-attention of the UNet and the DiT, with kernels K1-fwd and K1-bwd on the card.

Counterpart of ``stain2stain_tpu/ops/pallas_attention.py``. The TPU kernels
become CUDA C++ for ``sm_90a``, built by ``nvcc`` at first use and called
through ctypes (see the source notes for their bounds and designs):

- ``_fwd_kernel`` → ``csrc/attention_fwd.cu`` (:func:`fused_attention`, the
  kernel ``"K1-fwd"``);
- ``_bwd_kernel`` → ``csrc/attention_bwd.cu`` (:func:`fused_attention_backward`,
  ``"K1-bwd"``).

:class:`FusedAttention` is the ``torch.autograd.Function`` in place of the
JAX ``custom_vjp``: its forward is K1-fwd, which also returns each row's
log-sum-exp when a gradient is needed, and it saves (q, k, v, o, lse); its
backward is K1-bwd, which takes that lse instead of recomputing it. (The JAX
VJP saves only (q, k, v, o), ``pallas_attention.py:147-149``, because lane
padding made the statistics 128× larger on the TPU; on the card the lse is
an f32 (BH, T) array, 2 MiB at the 256-px training shape.)

Each wrapper launches its kernel on CUDA tensors and raises on anything the
kernel does not take; on CPU tensors it runs the kernel's plain version
(:func:`fused_attention_reference`, :func:`fused_attention_backward_reference`).
K1-fwd is the registered op ``s2s::attention_fwd`` (``torch.library.custom_op``
with a fake implementation for the shapes), so ``torch.export`` traces a
generator into a graph that holds it and a loaded program launches the kernel.
``ops.launches()["K1-fwd"]`` and ``["K1-bwd"]`` count the kernel launches, so
a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .._device import runs_plain

SUPPORTED_HEAD_DIMS = (16, 32, 64, 72)
# head dims of the bf16 tensor-core kernels alone (the f32 kernels tile d in 16s)
BF16_ONLY_HEAD_DIMS = (72,)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_K1_FWD = _build.Kernel("K1-fwd", "attention_fwd.cu", "s2s_attention_fwd",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float])
_K1_BWD = _build.Kernel("K1-bwd", "attention_bwd.cu", "s2s_attention_bwd",
                        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float])


def fused_attention_reference(q, k, v, scale: float, return_lse: bool = False):
    """Plain version of K1-fwd on (BH, T, d): f32 q·kᵀ·scale, softmax, ·v.

    With ``return_lse`` also each row's log-sum-exp of the scaled logits, f32 (BH, T).
    """
    s = torch.matmul(q.to(torch.float32) * scale, k.to(torch.float32).transpose(-1, -2))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.to(torch.float32)).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def fused_attention_backward_reference(q, k, v, o, do, scale: float, lse=None):
    """Plain version of K1-bwd on (BH, T, d): the flash identities of
    ``pallas_attention.py:85-105`` in f32; p = exp(s − lse) from the forward's
    log-sum-exp when given, the softmax recomputed otherwise.

    Returns (dq, dk, dv) in the inputs' dtype.
    """
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    of, dof = o.to(torch.float32), do.to(torch.float32)
    s = torch.matmul(qf * scale, kf.transpose(-1, -2))
    if lse is not None:
        p = torch.exp(s - lse.to(torch.float32)[..., None])
    else:
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
    if any(t.data_ptr() % 16 for t in tensors):  # the bf16 kernels copy 16-byte chunks (cp.async)
        raise ValueError("fused_attention needs tensors that start 16-byte aligned")
    bh, t, d = first.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"fused_attention supports head dims {SUPPORTED_HEAD_DIMS}, got {d}")
    if d in BF16_ONLY_HEAD_DIMS and first.dtype != torch.bfloat16:
        raise ValueError(f"fused_attention takes head dim {d} in bfloat16 only, got {first.dtype}")
    if bh * _tiles(t) >= 2**31:  # every kernel's grid: one block per (bh, 64 rows)
        raise ValueError(f"fused_attention grid too large for BH={bh}, T={t}")


def _tiles(t: int) -> int:
    return math.ceil(t / 64)


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    if lse.shape != q.shape[:2] or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 (BH, T) tensor beside q, got {tuple(lse.shape)} {lse.dtype}")


@torch.library.custom_op("s2s::attention_fwd", mutates_args=())
def _attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   return_lse: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The registered op of K1-fwd: (out, lse), lse empty unless asked for.

    Its one implementation launches the kernel on CUDA tensors (and counts the
    launch) and runs the plain version on CPU tensors, so a graph traced on
    either device holds this op and the count is taken when it runs.
    """
    if runs_plain("fused_attention", q, k, v):
        if return_lse:
            return fused_attention_reference(q, k, v, scale, return_lse=True)
        return fused_attention_reference(q, k, v, scale), q.new_empty((0,), dtype=torch.float32)
    _check(q, k, v)
    bh, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, t) if return_lse else (0,), dtype=torch.float32, device=q.device)
    _K1_FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   lse.data_ptr() if return_lse else None, bh, t, d, _DTYPE_CODES[q.dtype], float(scale))
    return out, lse


@_attention_fwd.register_fake
def _(q, k, v, scale, return_lse):
    runs_plain("fused_attention", q, k, v)  # raises for devices other than CUDA and CPU (meta)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_attention expects equal f32 or bf16 (BH, T, d) tensors, got {tuple(q.shape)} {q.dtype}")
    return torch.empty_like(q), q.new_empty(q.shape[:2] if return_lse else (0,), dtype=torch.float32)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, return_lse: bool = False):
    """(BH, T, d) q/k/v → (BH, T, d) softmax(q·kᵀ·scale)·v in q's dtype (K1-fwd,
    the op ``s2s::attention_fwd``).

    With ``return_lse`` returns (out, lse): also each row's log-sum-exp of the
    scaled logits, f32 (BH, T), which :func:`fused_attention_backward` takes.
    """
    out, lse = _attention_fwd(q, k, v, float(scale), bool(return_lse))
    return (out, lse) if return_lse else out


def fused_attention_backward(q, k, v, o, do, scale: float, lse=None):
    """(BH, T, d) q, k, v, o, do → (dq, dk, dv) in the inputs' dtype (K1-bwd).

    ``lse``: the forward's f32 (BH, T) log-sum-exp (``fused_attention(...,
    return_lse=True)``); without it the kernel recomputes it.
    """
    if runs_plain("fused_attention_backward", q, k, v, o, do, *([] if lse is None else [lse])):
        return fused_attention_backward_reference(q, k, v, o, do, scale, lse)
    _check(q, k, v, o, do)
    if lse is not None:
        _check_lse(lse, q)
    bh, t, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # (lse·log2 e, rowsum(do∘o)) per row, rows padded to a multiple of 64: the kernel's only scratch
    stats = torch.empty((bh, _tiles(t) * 64, 2), dtype=torch.float32, device=q.device)
    _K1_BWD.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        None if lse is None else lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        bh, t, d, _DTYPE_CODES[q.dtype], float(scale),
    )
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """softmax(q·kᵀ·scale)·v on (BH, T, d) with K1-fwd forward and K1-bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if any(ctx.needs_input_grad[:3]):
            out, lse = fused_attention(q, k, v, scale, return_lse=True)
        else:
            out, lse = fused_attention(q, k, v, scale), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, out, do.contiguous(), ctx.scale, lse)
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

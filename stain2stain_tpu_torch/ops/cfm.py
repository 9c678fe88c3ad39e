"""Conditional flow matching path sampling (counterpart of ``stain2stain_tpu/ops/cfm.py``).

``ConditionalFlowMatcher`` samples ``t ~ U(0,1)`` per example, the
straight-line interpolant ``xt = (1-t)·x0 + t·x1 (+ σ·ε)`` and the target
velocity ``ut = x1 - x0`` (σ = 0 is the flagship config's rectified-flow
path). ``TargetConditionalFlowMatcher`` is the Lipman et al. path from noise.

Randomness comes from an explicit ``torch.Generator``; ``t`` and ``eps`` can
be passed in instead, which is how the tests hand both packages the same
draws. Draws are made on the generator's device (the CPU by default) and
moved to the data's. Under data parallelism the trainer's generator knows
this rank's rows of the global batch: ``t`` and ``eps`` are drawn for the
global batch and sliced (:func:`~..parallel.mesh.draw_rows`), so each
example draws what it would in one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..parallel.mesh import draw_rows


def _bcast_t(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape per-example t (B,) for broadcasting against x (B, ...)."""
    return t.reshape(t.shape[0], *([1] * (x.ndim - 1)))


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    device = generator.device if generator is not None else like.device
    rows = draw_rows(lambda n: torch.randn((n, *shape[1:]), generator=generator, device=device, dtype=like.dtype),
                     shape[0], generator)
    return rows.to(like.device)


@dataclass(frozen=True)
class ConditionalFlowMatcher:
    """Straight-line CFM path sampler: q(xt|x0,x1) = N((1-t)x0 + t·x1, σ²)."""

    sigma: float = 0.0

    def sample_t(self, batch: int, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
        gen_device = generator.device if generator is not None else device
        return draw_rows(lambda n: torch.rand((n,), generator=generator, device=gen_device), batch, generator).to(device)

    def sample_xt(self, x0, x1, t, eps: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        tb = _bcast_t(t, x0).to(x0.dtype)
        mu = (1.0 - tb) * x0 + tb * x1
        if self.sigma == 0.0:
            return mu
        if eps is None:
            eps = _normal(x0.shape, x0, generator)
        return mu + self.sigma * eps

    def conditional_flow(self, x0, x1, t) -> torch.Tensor:
        del t  # constant along the straight-line path
        return x1 - x0

    def sample_location_and_conditional_flow(
        self, x0, x1, generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        """Returns (t, xt, ut), the torchcfm contract; ``t``/``eps`` injectable."""
        if t is None:
            t = self.sample_t(x0.shape[0], generator, device=x0.device)
        t = t.to(device=x0.device, dtype=torch.float32)
        xt = self.sample_xt(x0, x1, t, eps=eps, generator=generator)
        return t, xt, self.conditional_flow(x0, x1, t)


@dataclass(frozen=True)
class TargetConditionalFlowMatcher(ConditionalFlowMatcher):
    """Lipman-et-al. flow matching to a target distribution from noise."""

    def sample_xt(self, x0, x1, t, eps: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
        tb = _bcast_t(t, x1).to(x1.dtype)
        if eps is None:
            eps = _normal(x1.shape, x1, generator)
        return tb * x1 + (1.0 - (1.0 - self.sigma) * tb) * eps

    def conditional_flow(self, x0, x1, t) -> torch.Tensor:
        raise NotImplementedError("use sample_location_and_conditional_flow")

    def sample_location_and_conditional_flow(
        self, x0, x1, generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
    ):
        if t is None:
            t = self.sample_t(x1.shape[0], generator, device=x1.device)
        t = t.to(device=x1.device, dtype=torch.float32)
        if eps is None:
            eps = _normal(x1.shape, x1, generator)
        tb = _bcast_t(t, x1).to(x1.dtype)
        xt = self.sample_xt(x0, x1, t, eps=eps)
        ut = (x1 - (1.0 - self.sigma) * xt) / (1.0 - (1.0 - self.sigma) * tb)
        return t, xt, ut


__all__ = ["ConditionalFlowMatcher", "TargetConditionalFlowMatcher"]

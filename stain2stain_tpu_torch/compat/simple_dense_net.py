"""Weights of the MNIST MLP across the two packages."""

from __future__ import annotations

from typing import Any, Mapping

import torch

from .unet import _linear, _norm, _put

__all__ = ["simple_dense_net_state_dict_from_flax"]


def simple_dense_net_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX ``SimpleDenseNet``'s params (``variables["params"]`` as numpy)
    as the port's ``state_dict``: each ``Dense`` kernel (in, out) becomes a
    ``Linear.weight`` (out, in), each ``LayerNorm`` ``scale`` / ``bias`` its
    ``weight`` / ``bias``; the names (``dense_{i}``, ``norm_{i}``, ``head``)
    are kept."""
    sd: dict[str, torch.Tensor] = {}
    for name, p in params.items():
        _put(sd, name, _norm(p) if name.startswith("norm_") else _linear(p))
    return sd

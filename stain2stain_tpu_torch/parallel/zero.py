"""The optimizer with its moments sharded over the mesh's ``fsdp`` dim
(the port's ``trainer.fsdp``; JAX ``trainer.py:282-310``).

JAX shards the train state's leaves over ``fsdp`` by ``_fsdp_spec`` and lets
XLA gather them. The port keeps the parameters and the gradients whole on
every rank (DDP all-reduces the gradients over the whole world first) and
shards what the optimizer holds, ZeRO stage 1 over each fsdp group: a
parameter that :func:`~.mesh.fsdp_axis` shards (largest dim ≥
``fsdp_min_size`` and divisible by ``fsdp``) is updated on each rank only in
its slice of that dim, with the moments of that slice alone, and the slices
are then gathered; a parameter it replicates is updated whole on every rank,
as JAX replicates it. The update is elementwise, so it equals the unsharded
one.

Gathers are an ``all_reduce`` of a zero buffer that each rank fills with its
own slices: the sum of one value and zeros is that value exactly, and gloo
runs ``all_reduce`` on CUDA tensors (it has no ``all_gather`` there).

``state_dict`` gathers the moments into the unsharded optimizer's state dict
and ``load_state_dict`` takes one and keeps this rank's slices, so a
checkpoint moves between ``fsdp=2`` on two ranks and one process both ways.
Both are collective: every rank of the fsdp group calls them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import MESH_DIMS, fsdp_axis


class ShardedOptimizer:
    """``optimizer`` (built over whole parameters, not yet stepped) with its
    state sharded over ``mesh``'s fsdp dim. Duck-types the optimizer: ``step``,
    ``zero_grad``, ``param_groups``, ``state_dict``, ``load_state_dict``."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh, min_size: int = 1024):
        if optimizer.state:
            raise ValueError("ShardedOptimizer takes an optimizer that has not stepped yet")
        dim = MESH_DIMS.index("fsdp")
        self.optimizer = optimizer
        self.group = mesh.get_group(dim)
        self.size = mesh.size(dim)
        self.index = mesh.get_local_rank(dim)
        self.params: list[torch.nn.Parameter] = []
        self.axes: list[Optional[int]] = []
        self.shards: list[torch.Tensor] = []
        for group in optimizer.param_groups:
            shards = []
            for p in group["params"]:
                axis = fsdp_axis(tuple(p.shape), self.size, min_size)
                shard = p if axis is None else self._slice(p.detach(), axis).clone().requires_grad_(True)
                self.params.append(p)
                self.axes.append(axis)
                self.shards.append(shard)
                shards.append(shard)
            group["params"] = shards

    def _slice(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        n = t.shape[axis] // self.size
        return t.narrow(axis, self.index * n, n)

    def _gather(self, parts: list[tuple[torch.Tensor, int, torch.Tensor]]) -> list[torch.Tensor]:
        """Whole tensors from (this rank's slice, axis, a tensor of the whole
        shape) triples, in one collective."""
        if not parts:
            return []
        flat = torch.zeros(sum(like.numel() for _, _, like in parts), dtype=parts[0][2].dtype,
                           device=parts[0][2].device)
        views, offset = [], 0
        for part, axis, like in parts:
            view = flat[offset:offset + like.numel()].view(like.shape)
            self._slice(view, axis).copy_(part)
            views.append(view)
            offset += like.numel()
        dist.all_reduce(flat, group=self.group)
        return views

    @property
    def param_groups(self) -> list[dict]:
        return self.optimizer.param_groups

    def sharded(self) -> list[int]:
        return [i for i, axis in enumerate(self.axes) if axis is not None]

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(v.numel() * v.element_size() for s in self.optimizer.state.values()
                   for v in s.values() if torch.is_tensor(v))

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p, shard in zip(self.params, self.shards):
            p.grad = None
            shard.grad = None

    @torch.no_grad()
    def step(self) -> None:
        sharded = self.sharded()
        for i in sharded:
            # the whole parameter is the truth (a restore or a load writes it): its slice is refreshed
            self.shards[i].copy_(self._slice(self.params[i], self.axes[i]))
            grad = self.params[i].grad
            self.shards[i].grad = None if grad is None else self._slice(grad, self.axes[i]).contiguous()
        self.optimizer.step()
        by_dtype: dict = {}
        for i in sharded:
            by_dtype.setdefault(self.params[i].dtype, []).append(i)
        for idx in by_dtype.values():
            whole = self._gather([(self.shards[i], self.axes[i], self.params[i]) for i in idx])
            for i, w in zip(idx, whole):
                self.params[i].copy_(w)

    def state_dict(self) -> dict:
        """The unsharded optimizer's state dict (collective)."""
        sd = self.optimizer.state_dict()
        state = {k: dict(v) for k, v in sd["state"].items()}
        by_dtype: dict = {}  # dtype: [(param index, state key)]
        for i in self.sharded():
            for k, v in state.get(i, {}).items():
                if torch.is_tensor(v) and v.ndim > 0 and v.shape == self.shards[i].shape:
                    by_dtype.setdefault(v.dtype, []).append((i, k))
        for keys in by_dtype.values():
            parts = [(state[i][k], self.axes[i], state[i][k].new_empty(self.params[i].shape)) for i, k in keys]
            for (i, k), whole in zip(keys, self._gather(parts)):
                state[i][k] = whole.clone()
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, sd: dict) -> None:
        """Load an unsharded optimizer's state dict, keeping this rank's slices."""
        state = {int(k): dict(v) for k, v in sd["state"].items()}
        for i in self.sharded():
            for k, v in state.get(i, {}).items():
                if torch.is_tensor(v) and tuple(v.shape) == tuple(self.params[i].shape) and v.ndim > 0:
                    state[i][k] = self._slice(v, self.axes[i]).clone()
        self.optimizer.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


__all__ = ["ShardedOptimizer"]

"""ODE integrators for flow-matching inference (counterpart of ``stain2stain_tpu/ops/solvers.py``).

Fixed-step Euler / midpoint / Heun / RK4 and adaptive Dormand–Prince 5(4)
with the JAX package's semantics: ``num_steps`` counts *time nodes*
(``num_steps=2`` is one step from t=0 to t=1), times and step sizes are f32,
and dopri5 keeps the same tableau, FSAL, one scalar error norm over the whole
batch, step-size clip constants and ``max_steps``. The fixed-step loops are
Python loops; dopri5 is one while loop whose body accepts or rejects on the
device, a higher-order ``while_loop`` node under ``torch.export`` and a host
loop that reads its stop condition once a step when run directly.
``fn(t, x, *args)`` receives ``t`` as a 0-d f32 tensor on ``x``'s device and
the caller's ``args`` (tensors the velocity reads, such as labels or a mask).

Under ``torch.export`` the dopri5 loop body is a subgraph that may read only
its inputs: the tensors the velocity reads must come in through ``args``, and
the modules whose parameters and buffers it reads through ``modules`` (their
state is re-bound to the loop's inputs inside the body).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Sequence

import torch
from torch import nn

from ..utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

VelocityFn = Callable[..., torch.Tensor]  # (t, x, *args) -> dx/dt


def _euler_step(fn: VelocityFn, t, x, dt):
    return x + dt * fn(t, x)


def _midpoint_step(fn: VelocityFn, t, x, dt):
    k1 = fn(t, x)
    return x + dt * fn(t + 0.5 * dt, x + 0.5 * dt * k1)


def _heun_step(fn: VelocityFn, t, x, dt):
    k1 = fn(t, x)
    k2 = fn(t + dt, x + dt * k1)
    return x + 0.5 * dt * (k1 + k2)


def _rk4_step(fn: VelocityFn, t, x, dt):
    k1 = fn(t, x)
    k2 = fn(t + 0.5 * dt, x + 0.5 * dt * k1)
    k3 = fn(t + 0.5 * dt, x + 0.5 * dt * k2)
    k4 = fn(t + dt, x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "heun": _heun_step,
    "rk4": _rk4_step,
}


def odeint_fixed(
    fn: VelocityFn,
    x0: torch.Tensor,
    num_steps: int,
    method: str = "euler",
    t0: float = 0.0,
    t1: float = 1.0,
    args: Sequence[torch.Tensor] = (),
) -> torch.Tensor:
    """Integrate dx/dt = fn(t, x, *args) over ``linspace(t0, t1, num_steps)``."""
    if method not in _STEPPERS:
        raise ValueError(f"Unknown fixed-step method '{method}'; options: {sorted(_STEPPERS)}")
    n_intervals = int(num_steps) - 1
    if n_intervals <= 0:
        return x0
    stepper = _STEPPERS[method]
    dt = torch.tensor((t1 - t0) / n_intervals, dtype=torch.float32, device=x0.device)
    ts = t0 + dt * torch.arange(n_intervals, dtype=torch.float32, device=x0.device)
    def velocity(t, x):
        return fn(t, x, *args)

    x = x0
    for t in ts:
        x = stepper(velocity, t, x, dt)
    return x


# Dormand–Prince 5(4) Butcher tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _while_loop(cond, body, carried: tuple, args: tuple = (), modules: Sequence[nn.Module] = ()) -> tuple:
    """``carried = body(*carried, *args)`` while ``cond(*carried, *args)`` holds.

    Run directly it is a Python loop that reads the condition back to the host
    once an iteration. Under ``torch.export`` it is one higher-order
    ``while_loop`` node whose condition the program evaluates on the device;
    ``modules``' parameters and buffers join ``args`` as the node's inputs and
    are re-bound inside its subgraphs, which may read nothing else from
    outside. Both run the same ``body``.
    """
    if not torch.compiler.is_exporting():
        while bool(cond(*carried, *args)):
            carried = body(*carried, *args)
        return carried
    from torch._higher_order_ops.while_loop import while_loop_op
    from torch.nn.utils.stateless import _reparametrize_module

    states = [{**dict(m.named_parameters()), **dict(m.named_buffers())} for m in modules]
    flat = [t for state in states for t in state.values()]
    n_in = len(carried) + len(args)

    def rebound(fn):
        def run(*inputs):
            with contextlib.ExitStack() as stack:
                rest = iter(inputs[n_in:])
                for module, state in zip(modules, states):
                    stack.enter_context(_reparametrize_module(module, {name: next(rest) for name in state}))
                return fn(*inputs[:n_in])

        return run

    return tuple(while_loop_op(rebound(cond), rebound(body), tuple(carried), (*args, *flat)))


def odeint_dopri5(
    fn: VelocityFn,
    x0: torch.Tensor,
    t0: float = 0.0,
    t1: float = 1.0,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    max_steps: int = 1000,
    args: Sequence[torch.Tensor] = (),
    modules: Sequence[nn.Module] = (),
) -> torch.Tensor:
    """Adaptive Dormand–Prince RK45 with FSAL (6 velocity evaluations a step).

    One while loop over the carry (t, x, h, k1, n), accept or reject by
    ``torch.where``, as JAX's ``lax.while_loop`` body; :func:`_while_loop`
    makes it one exportable node. The error norm is one scalar over the whole
    batch (one step size for all examples). If the loop stops short of ``t1``
    (step size collapsed or ``max_steps`` hit), a warning says so and the
    partially integrated state is returned, as the JAX package does; an
    exported program cannot warn, as JAX's cannot where the runtime lacks
    host callbacks.
    """
    f32 = dict(dtype=torch.float32, device=x0.device)
    x0 = x0.to(torch.float32)
    span = t1 - t0

    def cond(t, x, h, k1, n, *args):
        return (t < t1 - 1e-9) & (n < max_steps)

    def body(t, x, h, k1, n, *args):
        h = torch.minimum(h, t1 - t)
        ks = [k1]
        for i in range(1, 7):
            xi = x
            for j, a in enumerate(_DP_A[i]):
                xi = xi + h * a * ks[j]
            ks.append(fn(t + _DP_C[i] * h, xi, *args))
        x5 = x
        err = torch.zeros_like(x)
        for k, b5, b4 in zip(ks, _DP_B5, _DP_B4):
            x5 = x5 + h * b5 * k
            err = err + h * (b5 - b4) * k
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        norm = torch.sqrt(torch.mean(torch.square(err / scale)))
        accept = norm <= 1.0
        factor = torch.clamp(0.9 * torch.pow(torch.clamp(norm, min=1e-10), -0.2), 0.2, 5.0)
        h_new = torch.clamp(h * factor, span * 1e-5, span)
        # FSAL: on acceptance ks[6] = fn(t + h, x5); on rejection (t, x) stay
        # and the cached k1 with them
        return (torch.where(accept, t + h, t), torch.where(accept, x5, x), h_new,
                torch.where(accept, ks[6], k1), n + 1)

    t = torch.tensor(t0, **f32)
    args = tuple(args)
    init = (t, x0, torch.tensor(span / 50.0, **f32), fn(t, x0, *args),
            torch.zeros((), dtype=torch.int64, device=x0.device))
    t, x, _, _, n = _while_loop(cond, body, init, args, modules)

    if not torch.compiler.is_exporting():
        t_final = float(t)
        if abs(t_final - t1) > 1e-6 * max(abs(span), 1.0):
            msg = (
                f"dopri5 stopped at t={t_final} of {t1} after {int(n)} steps (step size "
                "collapsed or max_steps hit); result is partially integrated"
            )
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
            log.warning(msg)
    return x


def integrate(
    fn: VelocityFn,
    x0: torch.Tensor,
    num_steps: int = 100,
    method: str = "euler",
    t0: float = 0.0,
    t1: float = 1.0,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    args: Sequence[torch.Tensor] = (),
    modules: Sequence[nn.Module] = (),
) -> torch.Tensor:
    """Unified entry: fixed-step methods or adaptive 'dopri5'. ``args``: the
    tensors ``fn`` takes after (t, x); ``modules``: those whose state it reads
    (module docstring)."""
    if method == "dopri5":
        return odeint_dopri5(fn, x0, t0=t0, t1=t1, atol=atol, rtol=rtol, args=args, modules=modules)
    return odeint_fixed(fn, x0, num_steps, method=method, t0=t0, t1=t1, args=args)


class SolverConfig:
    """Inference-solver spec (``configs/model/*.yaml: solver``). ``sensitivity``
    is accepted for config parity and ignored: sampling is forward-only."""

    def __init__(
        self,
        solver: str = "euler",
        atol: float = 1e-4,
        rtol: float = 1e-4,
        sensitivity: str = "adjoint",
    ):
        if solver != "dopri5" and solver not in _STEPPERS:
            raise ValueError(f"unknown solver {solver!r}; options: {sorted(_STEPPERS) + ['dopri5']}")
        self.solver = solver
        self.atol = atol
        self.rtol = rtol
        self.sensitivity = sensitivity

    def __call__(self, fn: VelocityFn, x0: torch.Tensor, num_steps: int,
                 args: Sequence[torch.Tensor] = (), modules: Sequence[nn.Module] = ()) -> torch.Tensor:
        return integrate(
            fn, x0, num_steps=num_steps, method=self.solver, atol=self.atol, rtol=self.rtol,
            args=args, modules=modules,
        )


__all__ = ["integrate", "odeint_fixed", "odeint_dopri5", "SolverConfig", "VelocityFn"]

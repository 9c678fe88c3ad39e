"""ODE integrators for flow-matching inference (counterpart of ``stain2stain_tpu/ops/solvers.py``).

Fixed-step Euler / midpoint / Heun / RK4 and adaptive Dormand–Prince 5(4)
with the JAX package's semantics: ``num_steps`` counts *time nodes*
(``num_steps=2`` is one step from t=0 to t=1), times and step sizes are f32,
and dopri5 keeps the same tableau, FSAL, one scalar error norm over the whole
batch, step-size clip constants and ``max_steps``. The loops are Python
loops; dopri5 reads its accept/stop decisions back to the host once a step.
``fn(t, x)`` receives ``t`` as a 0-d f32 tensor on ``x``'s device.
"""

from __future__ import annotations

import warnings
from typing import Callable

import torch

from ..utils.pylogger import RankedLogger

log = RankedLogger(__name__, rank_zero_only=True)

VelocityFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


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
) -> torch.Tensor:
    """Integrate dx/dt = fn(t, x) over ``linspace(t0, t1, num_steps)``."""
    if method not in _STEPPERS:
        raise ValueError(f"Unknown fixed-step method '{method}'; options: {sorted(_STEPPERS)}")
    n_intervals = int(num_steps) - 1
    if n_intervals <= 0:
        return x0
    stepper = _STEPPERS[method]
    dt = torch.tensor((t1 - t0) / n_intervals, dtype=torch.float32, device=x0.device)
    ts = t0 + dt * torch.arange(n_intervals, dtype=torch.float32, device=x0.device)
    x = x0
    for t in ts:
        x = stepper(fn, t, x, dt)
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


def odeint_dopri5(
    fn: VelocityFn,
    x0: torch.Tensor,
    t0: float = 0.0,
    t1: float = 1.0,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    max_steps: int = 1000,
) -> torch.Tensor:
    """Adaptive Dormand–Prince RK45 with FSAL (6 velocity evaluations a step).

    The error norm is one scalar over the whole batch (one step size for all
    examples). If the loop stops short of ``t1`` (step size collapsed or
    ``max_steps`` hit), a warning says so and the partially integrated state
    is returned, as the JAX package does.
    """
    f32 = dict(dtype=torch.float32, device=x0.device)
    x = x0.to(torch.float32)
    span = t1 - t0
    t = torch.tensor(t0, **f32)
    h = torch.tensor(span / 50.0, **f32)
    k1 = fn(t, x)
    n = 0

    while bool(t < t1 - 1e-9) and n < max_steps:
        h = torch.minimum(h, t1 - t)
        ks = [k1]
        for i in range(1, 7):
            xi = x
            for j, a in enumerate(_DP_A[i]):
                xi = xi + h * a * ks[j]
            ks.append(fn(t + _DP_C[i] * h, xi))
        x5 = x
        err = torch.zeros_like(x)
        for k, b5, b4 in zip(ks, _DP_B5, _DP_B4):
            x5 = x5 + h * b5 * k
            err = err + h * (b5 - b4) * k
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        norm = torch.sqrt(torch.mean(torch.square(err / scale)))
        factor = torch.clamp(0.9 * torch.pow(torch.clamp(norm, min=1e-10), -0.2), 0.2, 5.0)
        h_new = torch.clamp(h * factor, span * 1e-5, span)
        if bool(norm <= 1.0):
            t, x, k1 = t + h, x5, ks[6]  # FSAL: ks[6] = fn(t + h, x5)
        h = h_new
        n += 1

    t_final = float(t)
    if abs(t_final - t1) > 1e-6 * max(abs(span), 1.0):
        msg = (
            f"dopri5 stopped at t={t_final} of {t1} after {n} steps (step size "
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
) -> torch.Tensor:
    """Unified entry: fixed-step methods or adaptive 'dopri5'."""
    if method == "dopri5":
        return odeint_dopri5(fn, x0, t0=t0, t1=t1, atol=atol, rtol=rtol)
    return odeint_fixed(fn, x0, num_steps, method=method, t0=t0, t1=t1)


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

    def __call__(self, fn: VelocityFn, x0: torch.Tensor, num_steps: int) -> torch.Tensor:
        return integrate(
            fn, x0, num_steps=num_steps, method=self.solver, atol=self.atol, rtol=self.rtol
        )


__all__ = ["integrate", "odeint_fixed", "odeint_dopri5", "SolverConfig", "VelocityFn"]

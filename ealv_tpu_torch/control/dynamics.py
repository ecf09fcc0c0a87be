"""Planner dynamics (port of ``ealv_tpu/control/dynamics.py``).

Only the plain double integrator is ported: ``[pos; vel]`` with
posdot = 0.8 * vel and veldot = u, integrated by RK4. It is what every
state string with at most one rotation state (e.g. ``"xyw"``) selects.
States may carry leading batch dims, so candidate plans roll out together.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DynState(NamedTuple):
    """Carried planner-dynamics state; x (num_states,)."""

    x: torch.Tensor


def rk4_step(f, dt, x, u):
    """Classic RK4 integrator."""
    k1 = dt * f(x, u)
    k2 = dt * f(x + k1 / 2.0, u)
    k3 = dt * f(x + k2 / 2.0, u)
    k4 = dt * f(x + k3, u)
    return x + (1.0 / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


class DoubleIntegrator:
    """[pos; vel] with posdot = 0.8 * vel (the reference's velocity
    damping) and veldot = u."""

    def __init__(self, num_states: int, num_actions: int, dt: float, device="cuda"):
        self.num_states = num_states
        self.num_actions = num_actions
        self.dt = dt
        n, m = num_states, num_actions
        self.A = torch.zeros((n, n), device=device)
        self.A[:m, m: 2 * m] = torch.eye(m, device=device) * 0.8
        self.B = torch.zeros((n, m), device=device)
        self.B[m: 2 * m, :] = torch.eye(m, device=device)

    def init(self, x0) -> DynState:
        x = torch.zeros(self.num_states, device=x0.device)
        k = min(x0.shape[0], self.num_states)
        x[:k] = x0[:k]
        return DynState(x=x)

    def get_lin(self, s: DynState, u):
        """(A, B) linearization; constant for this model."""
        return self.A, self.B

    def f(self, x, u):
        """Ax + Bu over the trailing dim of x (..., n) and u (..., m)."""
        return x @ self.A.T + u @ self.B.T

    def step_x(self, x, u):
        return rk4_step(self.f, self.dt, x, u)

    def step(self, s: DynState, u) -> DynState:
        return DynState(x=self.step_x(s.x, u))


def make_dynamics(states: str, dt: float, use_magnitude: bool = False, device="cuda"):
    """Pick the dynamics model from the position state string. More than
    one of 'rpw' selects the SO(3) roll model and ``use_magnitude`` the
    speed-augmented one; neither is ported yet."""
    if sum(c in "rpw" for c in states) > 1:
        raise NotImplementedError("the SO(3) roll dynamics are not ported yet")
    if use_magnitude:
        raise NotImplementedError("the speed-augmented dynamics are not ported yet")
    n_pos = len(states)
    return DoubleIntegrator(num_states=2 * n_pos, num_actions=n_pos, dt=dt,
                            device=device)

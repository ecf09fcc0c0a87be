"""Planner dynamics (port of ``ealv_tpu/control/dynamics.py``).

Each model is a config object whose methods are functions of an explicit
``DynState`` (x, R). The state vector is ``[positions..., velocities...]``;
double integrators have ``num_actions = num_states // 2`` accelerations.
States may carry leading batch dims, so candidate plans roll out together.

``state_dependent`` says whether a model's linearization (A, B) depends on
the state: the plain double integrator's does not, so the planner
linearizes it once; the speed model's B follows the velocity signs and
the SO(3) roll model's A the angles and R, so the planner linearizes them
at every step of the horizon.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import rotations as rot


class DynState(NamedTuple):
    """Carried planner-dynamics state: x (..., num_states) and the rotation
    matrix R (..., 3, 3), the identity for the models without rotation."""

    x: torch.Tensor
    R: torch.Tensor


def rk4_step(f, dt, x, u):
    """Classic RK4 integrator."""
    k1 = dt * f(x, u)
    k2 = dt * f(x + k1 / 2.0, u)
    k3 = dt * f(x + k2 / 2.0, u)
    k4 = dt * f(x + k3, u)
    return x + (1.0 / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _matvec(M, v):
    """M (..., r, c) @ v (..., c) as a float32 elementwise sum."""
    return (M * v[..., None, :]).sum(-1)


class _Base:
    """x' = A x + B u with (A, B) frozen at the carried state for a whole
    step, RK4 or Euler."""

    state_dependent = False

    def __init__(self, num_states: int, num_actions: int, dt: float,
                 use_rk4: bool = True, device="cuda"):
        self.num_states = num_states
        self.num_actions = num_actions
        self.dt = dt
        self.use_rk4 = use_rk4
        self.device = torch.device(device)
        self.A = torch.zeros((num_states, num_states), device=device)
        self.B = torch.zeros((num_states, num_actions), device=device)

    def init(self, x0) -> DynState:
        x = torch.zeros(self.num_states, device=x0.device)
        k = min(x0.shape[0], self.num_states)
        x[:k] = x0[:k]
        return DynState(x=x, R=torch.eye(3, device=x0.device))

    def get_lin(self, s: DynState, u):
        """(A, B) at the carried state(s): (n, n), (n, m) for a model whose
        linearization is constant, else batched like ``s``."""
        return self.A, self.B

    def _f(self, A, B, x, u):
        if not self.state_dependent:
            return x @ A.T + u @ B.T
        return _matvec(A, x) + _matvec(B, u)

    def _integrate(self, s: DynState, u):
        A, B = self.get_lin(s, u)
        f = lambda x, uu: self._f(A, B, x, uu)
        if self.use_rk4:
            return rk4_step(f, self.dt, s.x, u)
        return s.x + f(s.x, u) * self.dt

    def step(self, s: DynState, u) -> DynState:
        return DynState(x=self._integrate(s, u), R=s.R)


class DoubleIntegrator(_Base):
    """[pos; vel] with pos' = 0.8 vel (the reference's velocity damping)
    and vel' = u."""

    def __init__(self, num_states: int, num_actions: int, dt: float,
                 use_rk4: bool = True, device="cuda"):
        super().__init__(num_states, num_actions, dt, use_rk4, device)
        m = num_actions
        self.A[:m, m: 2 * m] = torch.eye(m, device=device) * 0.8
        self.B[m: 2 * m, :] = torch.eye(m, device=device)


class DoubleIntegratorRoll(DoubleIntegrator):
    """Double integrator whose position states ``rpw`` (roll, pitch, yaw)
    are integrated on SO(3). The carried R enters A as the Euler-rate block
    B(r, p) @ R at [rpw, d_rpw]; ``step`` sets R <- exp(hat(w) dt) @ R and
    overwrites the angles with wrap(matrix_to_euler(R)); ``init`` builds R
    from the angles. ``angle_scale``/``angle_shift`` map planner angle
    coordinates to real angles."""

    state_dependent = True

    def __init__(self, num_states: int, num_actions: int, dt: float,
                 use_rk4: bool = True, rpw=(0, 1, 2), angle_scale=(1.0, 1.0, 1.0),
                 angle_shift=(0.0, 0.0, 0.0), device="cuda"):
        super().__init__(num_states, num_actions, dt, use_rk4, device)
        self.rpw = tuple(rpw)
        self._rpw = torch.tensor(self.rpw, device=device)
        self._d_rpw = self._rpw + num_actions
        self._scale = torch.tensor(tuple(angle_scale), device=device)
        self._shift = torch.tensor(tuple(angle_shift), device=device)

    def to_angles(self, v):
        """Planner coordinates -> real angles."""
        return v * self._scale + self._shift

    def from_angles(self, a):
        return (a - self._shift) / self._scale

    def get_lin(self, s: DynState, u):
        ang = self.to_angles(s.x.index_select(-1, self._rpw))
        Bj = rot.mm(rot.euler_rate_jacobian(ang), s.R)
        A = self.A.expand(*s.x.shape[:-1], *self.A.shape).clone()
        A[..., self._rpw[:, None], self._d_rpw[None, :]] = Bj
        return A, self.B

    def step(self, s: DynState, u) -> DynState:
        x = self._integrate(s, u)
        w = s.x.index_select(-1, self._d_rpw)
        R = rot.mm(rot.so3_exp(w * self.dt), s.R)
        ang = rot.wrap_angles(rot.matrix_to_euler_angles(R))
        return DynState(x=x.index_copy(-1, self._rpw, self.from_angles(ang)), R=R)

    def init(self, x0) -> DynState:
        s = super().init(x0)
        ang = self.to_angles(s.x.index_select(-1, self._rpw))
        return s._replace(R=rot.euler_angles_to_matrix(ang))


def make_dynamics(states: str, dt: float, use_rk4: bool = True, angle_scale=None,
                  angle_shift=None, device="cuda"):
    """Pick the model from the position state string: more than one of
    'rpw' selects the SO(3) roll model (which needs all three), else the
    double integrator."""
    n_pos = len(states)
    if sum(c in "rpw" for c in states) > 1:
        rpw = tuple(i for i, c in enumerate(states) if c in "rpw")
        if len(rpw) != 3:
            raise ValueError(f"roll dynamics need all of r, p, w; got {states!r}")
        kw = {}
        if angle_scale is not None:
            kw["angle_scale"] = tuple(angle_scale)
        if angle_shift is not None:
            kw["angle_shift"] = tuple(angle_shift)
        return DoubleIntegratorRoll(2 * n_pos, n_pos, dt, use_rk4, rpw=rpw,
                                    device=device, **kw)
    return DoubleIntegrator(2 * n_pos, n_pos, dt, use_rk4, device=device)

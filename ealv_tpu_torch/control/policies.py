"""Warm-start policies of the planner (port of
``ealv_tpu/control/policies.py``). Inside the planner's forward pass each
is a function of (x_t, nominal u_t):

  - ``act(x, u_t) -> u_eff``   the control applied at this step
  - ``dx(x, u_t) -> dmu/dx``   its (..., num_actions, num_states) Jacobian
  - ``shift(u, idx) -> u``     the warm-start transform; ``idx`` may be a
                               () int tensor, so no host sync is needed
  - ``rollout_args() -> dict`` ``act`` as the horizon kernel's policy
                               (``ops/rollout.py``)

States may carry leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import rollout as kernels


def _zeros_dx(x, m, n):
    return x.new_zeros((*x.shape[:-1], m, n))


@dataclasses.dataclass(frozen=True)
class RollPolicy:
    """Replay the nominal controls; for idx < 0 roll the sequence forward
    by -idx and zero the vacated tail; idx >= 0 leaves u as it is."""

    num_actions: int
    num_states: int

    def act(self, x, u_t):
        return u_t

    def rollout_args(self) -> dict:
        return dict(policy=kernels.PASS)

    def dx(self, x, u_t):
        return _zeros_dx(x, self.num_actions, self.num_states)

    def shift(self, u, idx):
        h = u.shape[0]
        t = torch.arange(h, device=u.device)
        rolled = u[(t - idx) % h]
        rolled = torch.where((t >= h + idx)[:, None], torch.zeros_like(rolled), rolled)
        return torch.where(torch.as_tensor(idx, device=u.device) >= 0, u, rolled)


@dataclasses.dataclass(frozen=True)
class ZeroPolicy:
    """Replay the nominal controls; zero them all for idx < 0."""

    num_actions: int
    num_states: int

    def act(self, x, u_t):
        return u_t

    def rollout_args(self) -> dict:
        return dict(policy=kernels.PASS)

    def dx(self, x, u_t):
        return _zeros_dx(x, self.num_actions, self.num_states)

    def shift(self, u, idx):
        return torch.where(torch.as_tensor(idx, device=u.device) < 0, torch.zeros_like(u), u)


@dataclasses.dataclass(frozen=True)
class BarrierPushPolicy:
    """Damp the velocity of a position state that is at its bound and still
    moving outward: u_i = -weight * vel_i, with dmu/dx[i, i+m] = -weight.
    The planner ignores the nominal controls on its first inner iteration
    (``shift`` zeroes u for idx <= 0)."""

    num_actions: int
    num_states: int
    weight: float = 5.0
    b_lo: float = -1.0
    b_hi: float = 1.0

    def _active(self, x):
        m = self.num_actions
        pos, vel = x[..., :m], x[..., m: 2 * m]
        return ((pos >= self.b_hi) & (vel > 0)) | ((pos <= self.b_lo) & (vel < 0))

    def act(self, x, u_t):
        vel = x[..., self.num_actions: 2 * self.num_actions]
        return torch.where(self._active(x), -self.weight * vel, u_t)

    def rollout_args(self) -> dict:
        return dict(policy=kernels.BARRIER, barrier=(self.weight, self.b_lo, self.b_hi))

    def dx(self, x, u_t):
        m = self.num_actions
        d = torch.where(self._active(x), -self.weight, 0.0).to(x.dtype)  # (..., m)
        out = _zeros_dx(x, m, self.num_states)
        out[..., :, m: 2 * m] = torch.diag_embed(d)
        return out

    def shift(self, u, idx):
        return torch.where(torch.as_tensor(idx, device=u.device) <= 0, torch.zeros_like(u), u)


@dataclasses.dataclass(frozen=True)
class LQRPolicy:
    """u = -K x with K from the continuous algebraic Riccati equation,
    solved once on the host (scipy, float64) at build time for the model's
    linearization at x = 1; K (m, n) then lives on the model's device."""

    num_actions: int
    num_states: int
    K: torch.Tensor

    @classmethod
    def create(cls, dyn, horizon: int):
        import numpy as np
        from scipy.linalg import solve_continuous_are

        s0 = dyn.init(torch.ones(dyn.num_states, device=dyn.device))
        A, B = dyn.get_lin(s0, torch.ones(dyn.num_actions, device=dyn.device))
        A, B = A.double().cpu().numpy(), B.double().cpu().numpy()
        m = dyn.num_actions
        Q = np.diag([5.0] * m + [1.0] * (dyn.num_states - m))
        R = np.eye(m) * 100.0 * horizon
        P = solve_continuous_are(A, B, Q, R, balanced=False)
        K = np.linalg.inv(R) @ B.T @ P
        return cls(num_actions=m, num_states=dyn.num_states,
                   K=torch.tensor(K, dtype=torch.float32, device=dyn.device))

    def act(self, x, u_t):
        return -(x @ self.K.T)

    def rollout_args(self) -> dict:
        return dict(policy=kernels.LQR, gain=self.K)

    def dx(self, x, u_t):
        return (-self.K).expand(*x.shape[:-1], *self.K.shape)

    def shift(self, u, idx):
        return u


def make_policy(name: str, dyn, horizon: int):
    if name == "Roll":
        return RollPolicy(dyn.num_actions, dyn.num_states)
    if name == "Zero":
        return ZeroPolicy(dyn.num_actions, dyn.num_states)
    if name == "BarrierPush":
        return BarrierPushPolicy(dyn.num_actions, dyn.num_states)
    if name == "LQR":
        return LQRPolicy.create(dyn, horizon)
    raise ValueError(f"unknown default policy {name!r}")

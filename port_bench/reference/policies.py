"""Warm-start policies of the planner (port of
``ealv_tpu/control/policies.py``). Inside the planner's forward pass each
is a function of (x_t, nominal u_t):

  - ``act(x, u_t) -> u_eff``   the control applied at this step
  - ``dx(x, u_t) -> dmu/dx``   its (..., num_actions, num_states) Jacobian
  - ``shift(u, idx) -> u``     the warm-start transform; ``idx`` may be a
                               () int tensor, so no host sync is needed

States may carry leading batch dims.
"""

from __future__ import annotations

import dataclasses

import torch


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

    def dx(self, x, u_t):
        m = self.num_actions
        d = torch.where(self._active(x), -self.weight, 0.0).to(x.dtype)  # (..., m)
        out = _zeros_dx(x, m, self.num_states)
        out[..., :, m: 2 * m] = torch.diag_embed(d)
        return out

    def shift(self, u, idx):
        return torch.where(torch.as_tensor(idx, device=u.device) <= 0, torch.zeros_like(u), u)



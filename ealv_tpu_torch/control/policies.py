"""Default warm-start policy of the planner (port of the ``Roll`` policy of
``ealv_tpu/control/policies.py``): ``act`` is the control applied at a
step, ``dx`` its Jacobian in the state, ``shift`` the warm-start transform
after a measured state update."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RollPolicy:
    """Replay the nominal controls; on a state update roll the sequence
    forward and zero the tail."""

    num_actions: int
    num_states: int

    def act(self, x, u_t):
        return u_t

    def dx(self, x, u_t):
        """(..., num_actions, num_states) zeros for x (..., num_states)."""
        return x.new_zeros((*x.shape[:-1], self.num_actions, self.num_states))

    def shift(self, u, idx):
        """Roll u (H, m) forward by the () int tensor ``idx`` >= 0 and zero
        the vacated tail; idx == 0 leaves u as it is."""
        h = u.shape[0]
        t = torch.arange(h, device=u.device)
        rolled = u[(t + idx) % h]
        rolled = torch.where((t >= h - idx)[:, None], torch.zeros_like(rolled), rolled)
        return torch.where(idx > 0, rolled, u)


def make_policy(name: str, dyn, horizon: int):
    if name == "Roll":
        return RollPolicy(dyn.num_actions, dyn.num_states)
    raise NotImplementedError(f"policy {name!r} is not ported yet")

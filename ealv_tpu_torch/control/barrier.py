"""Workspace barrier with an analytic gradient (port of
``BarrierFunction`` and ``setup_barrier`` of
``ealv_tpu/control/barrier.py``). States may carry leading batch dims."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class BarrierFunction:
    """barr(x) = sum_i 1[x_i outside lim_i] * w_i * (x_i - lim_i)^p_i,
    against both the lower and the upper (buffered) limit."""

    b_lim: torch.Tensor  # (n, 2) buffered limits
    barr_weight: torch.Tensor  # (n,)
    power: torch.Tensor  # (n,)

    @classmethod
    def create(cls, b_lim, barr_weight, power, b_buff: float = 0.1):
        b_lim = b_lim.float().clone()
        b_lim[:, 0] += b_buff
        b_lim[:, 1] -= b_buff
        n = b_lim.shape[0]
        as_vec = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                           device=b_lim.device).expand(n).clone()
        return cls(b_lim=b_lim, barr_weight=as_vec(barr_weight), power=as_vec(power))

    def _terms(self, x):
        n = self.b_lim.shape[0]
        xc = x[..., :n]
        d_lo = xc - self.b_lim[:, 0]
        d_hi = xc - self.b_lim[:, 1]
        return xc <= self.b_lim[:, 0], xc >= self.b_lim[:, 1], d_lo, d_hi

    def barr(self, x):
        """Penalty per state: x (..., n_states) -> (...)."""
        below, above, d_lo, d_hi = self._terms(x)
        zero = torch.zeros_like(d_lo)
        t = torch.where(below, self.barr_weight * d_lo ** self.power, zero)
        t = t + torch.where(above, self.barr_weight * d_hi ** self.power, zero)
        return t.sum(-1)

    def dbarr(self, x):
        """Analytic gradient (..., n_states), zero beyond the limit rows."""
        n = self.b_lim.shape[0]
        below, above, d_lo, d_hi = self._terms(x)
        zero = torch.zeros_like(d_lo)
        pw = self.power * self.barr_weight
        g = torch.where(below, pw * d_lo ** (self.power - 1), zero)
        g = g + torch.where(above, pw * d_hi ** (self.power - 1), zero)
        out = torch.zeros_like(x)
        out[..., :n] = g
        return out

    def batch(self, X):
        """Penalty for each row of a trajectory (..., T, n_states)."""
        return self.barr(X)


def setup_barrier(states: str, robot_lim, robot_ctrl_lim, non_vel_locs,
                  use_barrier: bool = True, position_barrier: bool = True,
                  velocity_barrier: bool = True, barr_weight: float = 5.0,
                  b_buff: float = 0.1):
    """Limits are [position lims; control lims], power 4 everywhere, and
    the weight vector zeroes the block the flags disable. Returns
    (barrier, barr_lim)."""
    robot_lim = robot_lim.float()
    barr_lim = torch.cat([robot_lim[list(non_vel_locs)], robot_ctrl_lim.float()], 0)
    if not use_barrier:
        raise NotImplementedError("NoBarrier is not ported yet")
    n = len(states)
    if position_barrier and not velocity_barrier:
        weights = [barr_weight] * n + [0.0] * n
    elif velocity_barrier and not position_barrier:
        weights = [0.0] * n + [barr_weight] * n
    else:
        weights = [barr_weight] * (2 * n)
    barrier = BarrierFunction.create(
        barr_lim, torch.tensor(weights, device=barr_lim.device),
        torch.full((2 * n,), 4.0, device=barr_lim.device), b_buff)
    return barrier, barr_lim

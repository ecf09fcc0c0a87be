"""Baseline exploration controllers (port of ``ealv_tpu/control/baselines.py``),
selected when the exploration method is not a *klerg variant:

  - ``randomWalk``: a smoothed random velocity with boundary rejection. Ten
    uniform candidate controls are each averaged with the last velocity;
    the first whose single-integrator step stays inside the workspace
    (shrunk by ``boundary_buffer``) wins, and when none does the robot
    teleports to a uniform pose.
  - ``uniform``: a teleport to a uniform pose every step, with the clipped
    finite difference as the velocity.

The draws come from the state's ``torch.Generator`` or are fed as a
``BaselineDraws``. The first-valid select stays on the device (``argmax`` on
the mask, then ``where``), so a step never waits on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..data.replay import TrajMemory


@dataclasses.dataclass
class BaselineState:
    x: torch.Tensor  # (n_pos,) position state
    last_vel: torch.Tensor  # (n_pos,)
    memory: TrajMemory  # visited (pos, vel) states
    gen: torch.Generator


@dataclasses.dataclass
class BaselineDraws:
    """One step's draws, fed instead of drawn, in [0, 1): the candidate
    controls ``cands`` (n_trials, n_pos) of ``randomWalk`` and the uniform
    teleport pose ``state_u`` (n_pos,) of either method."""

    cands: torch.Tensor | None
    state_u: torch.Tensor


class BaselineController:
    """The planner's ``save_update``/``step`` surface for the baselines;
    limits are ((lo, hi) x n_pos) in robot coordinates."""

    def __init__(self, method: str, dt: float, robot_lim, robot_ctrl_lim,
                 buffer_capacity: int = 3000, boundary_buffer: float = 0.05,
                 n_trials: int = 10, device="cuda"):
        if method not in ("randomWalk", "uniform"):
            raise ValueError(f"unknown baseline method {method!r}")
        self.method = method
        self.dt = dt
        self.lims = torch.as_tensor(robot_lim, dtype=torch.float32, device=device)
        self.ctrl = torch.as_tensor(robot_ctrl_lim, dtype=torch.float32, device=device)
        self.buffer_capacity = buffer_capacity
        self.boundary_buffer = boundary_buffer
        self.n_trials = n_trials
        self.device = device

    @property
    def n_pos(self) -> int:
        return self.lims.shape[0]

    def init_state(self, x0, seed: int = 0) -> BaselineState:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return BaselineState(
            x=x0.float()[: self.n_pos],
            last_vel=torch.zeros(self.n_pos, device=self.device),
            memory=TrajMemory.create(self.buffer_capacity, 2 * self.n_pos, self.device),
            gen=gen)

    def _draws(self, bs: BaselineState) -> BaselineDraws:
        """One step's draws from the state's generator."""
        rand = lambda *shape: torch.rand(shape, generator=bs.gen, device=self.device)
        cands = rand(self.n_trials, self.n_pos) if self.method == "randomWalk" else None
        return BaselineDraws(cands=cands, state_u=rand(self.n_pos))

    def step(self, bs: BaselineState, draws: BaselineDraws | None = None):
        """Returns (state', full state (pos + vel), vel)."""
        d = draws if draws is not None else self._draws(bs)
        lims, ctrl, old = self.lims, self.ctrl, bs.x
        state_u = d.state_u * (lims[:, 1] - lims[:, 0]) + lims[:, 0]
        vel_u = torch.clamp((state_u - old) / self.dt, ctrl[:, 0], ctrl[:, 1])
        if self.method == "randomWalk":
            vels = (bs.last_vel[None, :] + d.cands * (ctrl[:, 1] - ctrl[:, 0])
                    + ctrl[:, 0]) / 2.0
            states = old[None, :] + vels * self.dt
            b = self.boundary_buffer
            valid = ((states >= lims[:, 0] + b) & (states <= lims[:, 1] - b)).all(1)
            first = valid.to(torch.uint8).argmax().reshape(1)
            any_valid = valid.any()
            state = torch.where(any_valid, states.index_select(0, first)[0], state_u)
            vel = torch.where(any_valid, vels.index_select(0, first)[0], vel_u)
        else:
            state, vel = state_u, vel_u
        bs = dataclasses.replace(bs, x=state, last_vel=vel)
        return bs, torch.cat([state, vel]), vel

    def save_update(self, bs: BaselineState, full_state, save: bool = True):
        """Sync to a measured (pos, vel) state and record it; a measurement
        with a NaN is neither taken nor recorded."""
        full_state = full_state.float()
        bad = torch.isnan(full_state).any()
        x_new = torch.where(bad, bs.x, full_state[: self.n_pos])
        if save:
            bs.memory.push(torch.nan_to_num(full_state[: 2 * self.n_pos]), skip=bad)
        return dataclasses.replace(bs, x=x_new)

"""The evaluation runtime (port of ``ealv_tpu/runtime/tester.py``):
exploration with no learning, toward an injected target ``pdf_fn(ctx,
samples)`` (a fingerprint belief, an ``ExplrDist`` mixture, or a frozen
CVAE's uncertainty), over a subset of the configured states with the
limits re-sliced to it, and a pose controller that drives straight to a
pose.

The planner's target shaping is off (``weight_temp=False``,
``weight_env=False``): the injected target is planned on as it is, so a
plan makes one K1 launch fewer than the experiment's (no coverage spread).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..utils.config import ExperimentConfig, TRAY_LIM
from ..control.klerg import KlergConfig, KlergPlanner, PlannerState
from ..control.dynamics import make_dynamics
from ..control.policies import make_policy
from ..control.barrier import setup_barrier
from ..sim.arm import ArmEnv, ArmState
from ..sim.env import SyntheticEnv, EnvState
from ..sim.renderer import TrayScene
from .agent import ExploredStates, TickDraws, reject_unported


@dataclasses.dataclass
class EvalState:
    pstate: PlannerState
    env: EnvState | ArmState
    step: int = 0


class EvalExperiment:
    """Exploration-only runtime over the simulator on ``device``."""

    def __init__(self, cfg: ExperimentConfig, pdf_fn: Callable,
                 explr_states: Optional[str] = None,
                 scene: Optional[TrayScene] = None,
                 kernel_std_scale: float = 1.0, device="cuda"):
        reject_unported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # f32 math in full f32 on the card, as the Experiment's
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.explr_states = explr_states or cfg.states
        if not all(s in cfg.states for s in self.explr_states):
            raise ValueError(f"explr_states {self.explr_states!r} are not all in "
                             f"states {cfg.states!r}")
        self.explored = ExploredStates(cfg, self.explr_states, self.device)
        self.pos_states = "".join(s for s in self.explr_states if s == s.lower())
        self.dyn = make_dynamics(self.pos_states, dt=cfg.dt, device=self.device)
        kcfg = KlergConfig(
            horizon=cfg.horizon, num_target_samples=cfg.num_target_samples,
            num_traj_samples=cfg.num_traj_samples, dt=cfg.dt, R=cfg.R,
            std=cfg.std * kernel_std_scale,
            # the injected target is planned on unshaped: the coverage
            # exponent flattens any target while coverage is small
            weight_temp=False, weight_env=False, vel_smoothing=0.5)
        self.planner = KlergPlanner(
            kcfg, self.dyn, make_policy("Roll", self.dyn, cfg.horizon), pdf_fn,
            self.explr_states, explr_locs=list(range(len(self.explr_states))),
            device=self.device)
        # as in the reference, only "arm" selects the arm here; the other
        # arm backends run the free env (ealv_tpu/runtime/tester.py:93-99)
        env_cls = ArmEnv if cfg.sim_backend == "arm" else SyntheticEnv
        self.env = env_cls(tray_lim=tuple(TRAY_LIM[s] for s in "xyzrpw"),
                           dt=cfg.dt / 5.0, img_hw=cfg.image_dim[:2], device=str(self.device))
        self.scene = scene

    def init(self, start_tray_pose=None, seed: int = 0, shrink_center=None,
             shrink_scale: float = 0.4) -> EvalState:
        """Start at ``start_tray_pose`` (6,) (default the tray centre), the
        planner's draws seeded with ``seed``. ``shrink_center`` (robot
        coords over the explored position states) narrows the sampling
        limits and the barrier to +-``shrink_scale`` around it."""
        ex, n_pos = self.explored, len(self.pos_states)
        barrier, _ = setup_barrier(self.pos_states, ex.robot_lim,
                                   ex.robot_ctrl_lim[:n_pos], list(range(n_pos)))
        if start_tray_pose is None:
            start_tray_pose = [(lo + hi) / 2 for lo, hi in self.env.tray_lim]
        start = torch.as_tensor(start_tray_pose, dtype=torch.float32, device=self.device)
        x0r = ex.start(start)
        pstate = self.planner.init_state(
            torch.cat([x0r, torch.zeros_like(x0r)]), ex.robot_lim, barrier,
            buffer_capacity=self.cfg.traj_buffer_capacity,
            explr_lim_scale=self.cfg.explr_robot_lim_scale, seed=seed)
        if shrink_center is not None:
            center = torch.as_tensor(shrink_center, dtype=torch.float32,
                                     device=self.device)[:n_pos]
            new_lims = center[:, None] + torch.tensor([-1.0, 1.0], device=self.device) \
                * shrink_scale
            pstate = self.planner.update_lims(pstate, list(range(n_pos)), new_lims,
                                              ex.robot_ctrl_lim[:n_pos])
        return EvalState(pstate=pstate, env=self.env.init(start, scene=self.scene))

    def use_pose(self, ev: EvalState, tray_pose, n_steps: int = 30) -> EvalState:
        """Drive straight to ``tray_pose`` (6,) with the pose controller."""
        pose = torch.as_tensor(tray_pose, dtype=torch.float32, device=self.device)
        env = ev.env
        for _ in range(n_steps):
            env = self.env.step_pose(env, pose)
        return dataclasses.replace(ev, env=env)

    def tick(self, ev: EvalState, pdf_ctx, draws: TickDraws | None = None):
        """One exploration step; ``draws`` feeds the planner's samples and
        history indices. Returns (ev, {robot_state, image, force, cost})."""
        pstate = self.planner.save_update(ev.pstate, self.explored.measured(ev.env),
                                          save=True)
        pstate, info = self.planner.plan(pstate, pdf_ctx,
                                         samples=draws.samples if draws else None,
                                         hist_idx=draws.hist_idx if draws else None)
        m = self.dyn.num_actions
        x_pred = self.dyn.step(pstate.dyn, pstate.u[0]).x
        vel6, b_cmd = self.explored.command(x_pred[:m], x_pred[m:])
        env = self.env.step_vel(ev.env, vel6, b_cmd)
        _, _, force, img = self.env.observe(env)
        if self.cfg.image_dim[2] == 1:
            img = img.mean(-1, keepdim=True)
        robot_state = self.explored.measured(env)[: len(self.explr_states)]
        ev = EvalState(pstate=pstate, env=env, step=ev.step + 1)
        return ev, dict(robot_state=robot_state, image=img, force=force, cost=info["cost"])

"""The evaluation runtime (port of ``ealv_tpu/runtime/tester.py``):
exploration with no learning, toward an injected target ``pdf_fn(ctx,
samples)`` (a fingerprint belief, an ``ExplrDist`` mixture, or a frozen
CVAE's uncertainty), over a subset of the configured states with the
limits re-sliced to it, and a pose controller that drives straight to a
pose.

The planner's target shaping is off (``weight_temp=False``,
``weight_env=False``): the injected target is planned on as it is, so a
plan makes one K1 launch fewer than the experiment's (no coverage spread).

On the card a tick runs as a captured CUDA graph (``tick_graph``, a
``runtime/graphs.py`` ``StepGraph`` in its own memory pool), as the JAX
package runs its tick as one jitted program; so does each step that holds
the tick (``step``: the fingerprint capture's tick and encode, the
identification's tick, match and fusion), one graph a pattern of the host
values the step branches on (the arm's drift correction, the step's own).
The planner's draws come from its registered generator or are staged fed
draws; what the step reads in place (the planner's tensors, the target
context) keys its graphs by address. With ``tick_graph`` set to None the
steps run eagerly.
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
from .agent import ExploredStates, TickDraws, advance_env, drift_key, reject_unported, \
    sim_carry, step_base, with_sim_carry
from . import tracing
from .graphs import StepGraph, inplace_key, run_step


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
        # the captured steps on the card, one memory pool for their patterns
        self.tick_graph = (StepGraph(pool=torch.cuda.MemPool())
                           if self.device.type == "cuda" else None)

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
        """One exploration step toward ``pdf_ctx`` (through the tick graph
        where the runtime has one; the context is read in place);
        ``draws`` feeds the planner's samples and history indices. Returns
        (ev, {robot_state, image, force, cost})."""

        def run(view, extra, d):
            view, obs = self._tick(view, pdf_ctx, d)
            return view, extra, obs

        with tracing.tick():
            ev, _, obs = self.step(ev, (), draws, run, ("tick",), inplace_key(pdf_ctx))
        return ev, obs

    def step(self, ev: EvalState, extra, draws, run, pattern: tuple, *reads):
        """One step that holds the eval tick, through the tick graph where
        the runtime has one (``graphs.run_step``: a pattern's first step
        runs eagerly, its second captures, later ones replay), else
        eagerly. ``extra`` is the step's carry beside the eval state (the
        capture's model state, the identification's beliefs); ``run(view,
        extra, draws)`` makes the step on a view of ``ev``, ticking through
        ``_tick``, and returns (eval state, extra, out). ``pattern`` keys
        the host values the step branches on (the arm's drift correction
        is added here), ``reads`` what else it reads in place. Returns (ev,
        extra, out): after a replay ``ev`` and ``extra`` are the graph's
        static buffers, which the next replay overwrites; out is cloned.
        The tracer's device span ``tick`` runs from the step body's first
        kernel to its last."""
        def traced(view, extra, d):
            tracing.begin("tick")
            view, extra, out = run(view, extra, d)
            tracing.end("tick")
            return view, extra, out

        if self.tick_graph is None:
            return traced(ev, extra, draws)
        gen = ev.pstate.gen

        def split(state):
            ev, extra = state
            return (*sim_carry(ev.pstate, ev.env), extra)

        def join(state, carry):
            ev = state[0]
            pstate, env = with_sim_carry(ev.pstate, ev.env, carry[:2])
            return dataclasses.replace(ev, pstate=pstate, env=env), carry[2]

        def body(state, d):
            ev, extra, out = traced(*state, d)
            return (ev, extra), out

        (view, extra), out = run_step(
            self.tick_graph, (ev, extra), split, join,
            lambda state, carry: step_base(self.planner, (gen,), carry, *reads),
            (*pattern, drift_key(self.env, ev.env, 1)), draws, body, [gen])
        return (dataclasses.replace(view, env=advance_env(view.env, 1), step=ev.step + 1),
                extra, out)

    def _tick(self, ev: EvalState, pdf_ctx, draws: TickDraws | None = None):
        """The tick's body, with the tracer's device span ``env`` from the
        command to the render (``step`` stamps ``tick`` around the whole
        step)."""
        pstate = self.planner.save_update(ev.pstate, self.explored.measured(ev.env),
                                          save=True)
        pstate, info = self.planner.plan(pstate, pdf_ctx,
                                         samples=draws.samples if draws else None,
                                         hist_idx=draws.hist_idx if draws else None)
        m = self.dyn.num_actions
        x_pred = self.dyn.step(pstate.dyn, pstate.u[0]).x
        tracing.begin("env")
        vel6, b_cmd = self.explored.command(x_pred[:m], x_pred[m:])
        env = self.env.step_vel(ev.env, vel6, b_cmd)
        _, _, force, img = self.env.observe(env)
        if self.cfg.image_dim[2] == 1:
            img = img.mean(-1, keepdim=True)
        tracing.end("env")
        robot_state = self.explored.measured(env)[: len(self.explr_states)]
        ev = EvalState(pstate=pstate, env=env, step=ev.step + 1)
        return ev, dict(robot_state=robot_state, image=img, force=force, cost=info["cost"])

"""One step of the host loop's device-resident pipelined runner
(``HostLoopRunner.step`` over a ``SyntheticBridge`` on the ``arm-dynamic``
arm, with no trainer call), recomputed in plain torch from the state
before it.

The step, as the port's runner makes it:

1. a prime where no plan is pending (the first step, or one after a stuck
   hit): a plan from the arm's observation on the experiment's planner
   state, drawing from the planner's generator;
2. the pending plan's command (``cmd7`` = [twist | brightness, < 0 keeps
   it]) on the arm (``reference/arm.py``), then the observation: pose,
   twist, the contact force (3,) and the camera image;
3. the absorb, with no trainer call: the image pushed to the ring in the
   compute dtype, the target's latent reseeded from the observation;
4. the next plan from the same observation on the pending plan's state,
   drawing on from the generator where the pending plan left it;
5. the deferred watchdog (``ealv_tpu_torch/runtime/watchdog.py``'s
   ``StuckDetector``, copied): the previous step's slice (pose, twist,
   force) against the pose it checked before; where the pose moved less
   than ``STUCK_TOL``, an escape twist along the force's direction on the
   arm (no escape without a force) and the plan dropped.

The planner, the dynamics and the CVAE are ``reference/tick.py``'s
pieces (built for the free env, whose place the arm takes). ``cast`` and
``ring_cast`` set the CVAE's products' and the ring row's precision;
``stuck`` plants the fault of a step that leaves its state unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cvae as cvae_mod
from .arm import ArmEnv, ArmState
from .dynamics import DynState
from .klerg import PlannerState
from .renderer import TrayScene
from .replay import TrajMemory
from .tick import TRAY6, Tick

STUCK_TOL = 1e-5  # StuckDetector.tol: a pose that moved less is stuck
ESCAPE_SPEED = 0.05  # StuckDetector.escape_speed
NO_FORCE = 1e-6  # a force of no larger norm gives no escape direction


class HostLoopStep:
    """The pieces of a host-loop step for one configuration."""

    def __init__(self, cfg, device, cast=cvae_mod.no_cast, ring_cast=cvae_mod.no_cast,
                 stuck: bool = False):
        if cfg.sim_backend != "arm-dynamic":
            raise NotImplementedError(f"the reference host loop covers 'arm-dynamic', not "
                                      f"{cfg.sim_backend!r}")
        device = torch.device(device)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.device, self.stuck = cfg, device, stuck
        self.tick = Tick(dataclasses.replace(cfg, sim_backend="free"), device, True, cast,
                         ring_cast)
        self.ring_cast = ring_cast
        self.arm = ArmEnv(tray_lim=TRAY6, dt=cfg.dt / 5.0, img_hw=cfg.image_dim[:2],
                          obj_mobility=cfg.obj_mobility, device=str(device))
        self.scene = TrayScene.default(device)

    def make_model(self, seed=None):
        return self.tick.make_model(seed)

    def _pstate(self, snap: dict, gen) -> PlannerState:
        memory = TrajMemory(buf=snap["mem_buf"].clone(), pos=snap["mem_pos"].clone(),
                            size=snap["mem_size"].clone())
        return PlannerState(u=snap["u"], dyn=DynState(x=snap["dyn_x"], R=snap["dyn_R"]),
                            memory=memory, lims=snap["lims"], barrier=self.tick.barrier,
                            last_plan=snap["last_plan"], gen=gen)

    def _plan(self, pstate, env: ArmState, pdf_ctx):
        """Sync the planner to the arm's measured state, plan, and pack the
        command: (pstate, info, cmd7)."""
        t = self.tick
        pstate = t.planner.save_update(pstate, t.ex.measured(env), save=True)
        pstate, info = t.planner.plan(pstate, pdf_ctx)
        x_pred = t.dyn.step(pstate.dyn, pstate.u[0]).x
        vel6 = t.ex.command(x_pred[t.dyn.num_actions:])
        return pstate, info, torch.cat([vel6, vel6.new_full((1,), -1.0)])

    def arm_state(self, snap: dict) -> ArmState:
        return ArmState(q=snap["q"], qdot=snap["qdot"], pose=snap["pose"], vel=snap["vel"],
                        brightness=snap["brightness"], count=snap["arm_count"],
                        scene=self.scene)

    def step(self, snap: dict, model) -> dict:
        """The step after ``snap`` (``entries/hostloop.py``'s snapshot)
        toward ``model``: the plan it made (``u``, ``cost``), the robot
        state it absorbed, the ring row it pushed (``image``), the
        reseeded latent ``z`` and the arm's joints ``q`` after it."""
        t, dev, s_dim = self.tick, self.device, self.cfg.s_dim
        env = self.arm_state(snap)
        mstate = cvae_mod.ModelState(*(snap[k] for k in (
            "seed_x", "seed_y", "seed_force", "z", "z_buff", "initialized")))
        pending = snap["pending"]
        if self.stuck:
            _, _, _, img = self.arm.observe(env)
            return dict(cost=torch.zeros((), device=dev), robot_state=t.ex.measured(env)[:s_dim],
                        image=torch.zeros_like(img), z=snap["z"], q=snap["q"],
                        u=(pending or snap)["u"])
        gen = torch.Generator(device=dev)
        if pending is None:  # the prime: from the experiment's planner state
            gen.set_state(snap["planner_gen"])
            pstate, _, cmd7 = self._plan(self._pstate(snap, gen), env, (model, mstate))
        else:
            gen.set_state(pending["planner_gen"])
            pstate, cmd7 = self._pstate(pending, gen), pending["cmd7"]
        # the bridge: command and observe
        b = torch.where(cmd7[6] >= 0, cmd7[6], env.brightness)
        env = self.arm.step_vel(env, cmd7[:6], b)
        _, _, _, img = self.arm.observe(env)
        # the absorb: no trainer call
        robot_state = t.ex.measured(env)[:s_dim]
        pushed = self.ring_cast(img)
        mstate = cvae_mod.update_dist(model, mstate, robot_state, img, mstate.seed_force)
        pstate, info, _ = self._plan(pstate, env, (model, mstate))
        # the deferred watchdog, on the previous step's slice
        held = snap["held"]
        if held is not None:
            pos = np.asarray(held[:6], np.float64)
            last = snap["stuck_last"]
            if last is not None and np.linalg.norm(last - pos) < STUCK_TOL:
                f = np.asarray(held[12:], np.float64).ravel()[:3]
                if np.linalg.norm(f) > NO_FORCE:
                    esc6 = np.zeros(6)
                    esc6[:3] = ESCAPE_SPEED * f / np.linalg.norm(f)
                    env = self.arm.step_vel(env, torch.as_tensor(np.asarray(esc6, np.float32),
                                                                 device=dev))
        return dict(cost=info["cost"], robot_state=robot_state, image=pushed, u=pstate.u,
                    z=mstate.z, q=env.q)

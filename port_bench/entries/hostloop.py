"""``HostLoopRunner.step`` in its default form, the device-resident
pipelined step, over a ``SyntheticBridge`` on the ``arm-dynamic`` Panda:
the robot-facing loop.

Set-up follows ``ealv_tpu_torch/scripts/run_fingerprint_matrix.py``'s
``learn_host_loop`` without learning: ``Experiment(cfg,
train_calls_per_tick=<traffic>)`` (0: the published trainer runs out of
line, so the CVAE stays at its seed weights), ``init(seed)``, and the
runner over a bridge on the experiment's env state. A step replays the
runner's ``step_graph`` (command, observe, absorb, plan); a prime, the
first step or one after a stuck hit, replays ``plan_graph`` first. Set-up
makes two steps and then drops the pipeline once, unless a stuck hit has
done so, so that the third step's prime captures ``plan_graph``: a stuck
hit inside the window then replays it.

``will_train`` marks the steps whose command the arm's drift correction
follows (every ``reference.arm.DRIFT_EVERY``-th command): the traffic's
``compare`` draws at least one of them (``trained``), so at least one
compared step runs the IK.
"""

from __future__ import annotations

from ..drive import Driver, params, planner_snapshot, reference_config
from ..reference import arm as ref_arm
from ..reference import cvae as ref_cvae
from ..reference.hostloop import HostLoopStep


class Entry(Driver):
    learning = True  # the experiment's planner is the explore-and-learn one
    checked = ("ergodic_cost",)

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from ealv_tpu_torch.hw.bridge import SyntheticBridge
        from ealv_tpu_torch.runtime import Experiment, HostLoopRunner
        self.exp = Experiment(self.cfg, train_calls_per_tick=traffic["train_calls_per_tick"],
                              device=device)
        self.es = self.exp.init(seed)
        self.start = params(self.es.model)
        self.runner = HostLoopRunner(self.exp, SyntheticBridge(self.exp.env, self.es.env))
        # the step's info the entry reads: a program without it fails here, before any step
        self.runner.last_info
        self.tick()
        self.tick()
        plan_graph = self.runner.plan_graph
        if plan_graph is not None and plan_graph.captures == 0:
            self.runner._drop_pipeline()
            self.tick()

    def settled_count(self) -> int:
        return sum(g.warmups + g.captures for g in (self.runner.plan_graph,
                                                    self.runner.step_graph) if g is not None)

    def tick(self) -> dict:
        self.es = self.runner.step(self.es)
        return self.runner.last_info

    def fill(self) -> int:
        return int(self.es.pstate.memory.size)

    def will_train(self) -> bool:
        return (self.runner.bridge.state.count + 1) % ref_arm.DRIFT_EVERY == 0

    def snapshot(self) -> dict:
        r, es = self.runner, self.es
        arm, ms = r.bridge.state, es.mstate
        pending = None
        if r._pending is not None:
            pstate, _, cmd7, _ = r._pending
            pending = dict(planner_snapshot(pstate), cmd7=cmd7.clone())
        last = r.stuck.last_pos
        return dict(
            **planner_snapshot(es.pstate), pending=pending,
            q=arm.q.clone(), qdot=arm.qdot.clone(), pose=arm.pose.clone(),
            vel=arm.vel.clone(), brightness=arm.brightness.clone(), arm_count=arm.count,
            seed_x=ms.seed_x.clone(), seed_y=ms.seed_y.clone(),
            seed_force=ms.seed_force.clone(), z=ms.z.clone(), z_buff=ms.z_buff.clone(),
            initialized=ms.initialized.clone(), ring_pos=es.buf.pos.clone(),
            held=r._prev_small, stuck_last=None if last is None else last.copy())

    def outputs(self, snap: dict, info: dict) -> dict:
        """What the step after ``snap`` produced: the plan it made (kept
        where a stuck hit dropped it), the robot state it absorbed, the
        reseeded latent and the arm's joints; the pushed image is read from
        the ring once the window has closed (``ring_images``)."""
        pstate, plan_info, _ = self.runner.last_plan
        return dict(cost=plan_info["cost"].clone(), u=pstate.u.clone(),
                    robot_state=info["robot_state"], z=self.es.mstate.z.clone(),
                    q=self.runner.bridge.state.q.clone(), trained=False)

    def ring_images(self):
        """The ring's images (it never wraps in a run: ``num_steps`` and
        set-up's steps stay below its capacity)."""
        return self.es.buf.y

    def free(self) -> None:
        self.exp = self.es = self.runner = None

    def reference(self, cast=None, ring_cast=None, half_batch: bool = False,
                  stuck: bool = False) -> HostLoopStep:
        """The reference step; ``half_batch`` plants nothing here (the step
        makes no trainer call)."""
        stated = ref_cvae.CASTS[self.cfg_dict["compute_dtype"]]
        return HostLoopStep(reference_config(self.cfg_dict), self.device, cast or stated,
                            ring_cast or stated, stuck=stuck)

    def target(self, tick: HostLoopStep):
        return tick.make_model(self.seed)

    def recompute(self, tick: HostLoopStep, target, snap: dict, ring_y, u=None) -> dict:
        held = snap["held"]
        snap = dict(snap, held=None if held is None else held.numpy())
        return tick.step(snap, target)

    def extra_gaps(self, prog: dict, ref: dict, snap: dict) -> dict:
        """``joints``: the arm's joints after the step, the largest gap over
        the largest joint of the reference's."""
        return dict(joints=float((prog["q"].float() - ref["q"].float()).abs().max()
                                 / ref["q"].float().abs().max().clamp(min=1e-30)))

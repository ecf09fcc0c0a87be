"""Host-in-the-loop experiment runtime, the robustness layer wired (port
of ``ealv_tpu/runtime/host_loop.py``).

Parity targets:
  - service-exception -> pause + recovery (sensor_main_module.py:153-166),
  - stuck-pose detection + force-direction escape command
    (sensor_utils.check_cmd :444-457, vel_move_force_norm :460-476),
  - goal-seek retry loop with joint reset + yaw-unstick
    (sensor_utils.check_goal_pos :375-441),
  - the random_listener auto-recovery heartbeat (scripts/random_listener:44-117),
  - pause/resume/manual/save topic surface (sensor_utils :556-578) via
    ControlPanel/ControlHooks.

``Experiment.tick`` steps its env directly and has no I/O to fail. This
runtime drives the same halves (``Experiment.plan_step`` and
``absorb_step``) through a ``RobotBridge`` (a simulator, the native
controller mux, or a robot driver): the deployment shape, where commands
fail, robots wedge and operators press pause. Every recovery event is
logged to the MetricsLog.

Three step forms share one command convention (``_plan_cmd7``) and behave
the same: the serial step (plan, command, observe, absorb); the
host-pipelined step, which plans step t+1 right after absorbing step t from
the same observation a serial step would plan from, so the command is
ready when the next step starts; and the device-resident step, for bridges
that can command and observe on the device (``SyntheticBridge``), where the
packed observation never leaves the device and only the small watchdog
slice (pose, vel, force, brightness) is copied to pinned host memory,
checked one step later. A plan that is not used (a pause, a failed
command, a stuck hit, a recovery) leaves the experiment state as it was:
each plan runs on the runner's fork of the planner's state, a ring and a
generator that the runner owns and reuses (``_fork``). A plan's staging
copies the planner's ring into the fork's ring and sets the fork's
generator from the planner's; an absorb adopts the plan by copying back
(``_adopt``). The experiment's ring and generator stay the same objects,
so the graphs that read them in place, and register the fork's generator,
keep their keys from plan to plan. Two generators that swapped roles at
each adoption would change the registered generators, and with them the
step graphs' base key, at every step; ``graphsafe_set_state`` would swap
the state object a graph registered. ``set_state`` writes the seed and
offset into that object, and the graph's next replay reads them.

On the card the device work of every step runs as captured CUDA graphs
(``runtime/graphs.py`` ``StepGraph``s in the experiment's memory pool),
one graph a pattern of the host values the step branches on: a plan from
a host observation (the first step, after a drop, and every serial step)
through ``plan_graph``, whose pattern is whether the plan targets the
prior; and the runner's own step through ``step_graph``: the
absorb-and-plan of the pipelined forms (the device-resident step with the
bridge's command and observation, the host-pipelined step with the host
observation staged) or the serial step's absorb, whose patterns are which
trainer calls the absorb makes, whether the next plan targets the prior,
the arm's drift correction and whether the plan sends a brightness. The
counterpart of the JAX runner's jitted ``_plan``, ``_absorb``,
``_absorb_plan`` and ``_cmd_absorb_plan``. Pause, stuck detection, escape
and recovery stay on the host, between steps. After a replay of the
runner's step the experiment state's fields and the pending plan are the
graph's static buffers, which the next replay overwrites: copy what you
keep. With ``plan_graph`` and ``step_graph`` set to None, and on the CPU,
everything runs eagerly.

Tracing (``runtime/tracing.py``): ``step`` is one tick, the host ``tick``
span around it and the device ``tick`` from its first kernel to its last;
inside, the planner's ``decode`` and ``descent``, ``env`` (the plan's
command conversion), ``absorb``, the device span ``arm`` around the
bridge's command and observation in the composed step, and the host span
``watchdog`` around the stuck check (the wait for the slice's copy, the
check and any escape). The host counters: ``prime`` (a plan from a host
observation), ``stuck``, ``escape``, ``recover`` and ``drift`` (the arm's
drift corrections, read from its host command counter).
"""

from __future__ import annotations

import dataclasses
from dataclasses import KW_ONLY, dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.host_copy import HostCopy
from . import tracing
from .agent import Experiment, ExperimentState, TickDraws, advance_env, drift_key, \
    sim_carry, with_sim_carry
from .graphs import CaptureError, StepGraph, _addresses, run_step
from .metrics import MetricsLog
from .panel import ControlHooks
from .watchdog import (
    GoalSeeker,
    GracefulKiller,
    PauseManager,
    RecoveryHeartbeat,
    StuckDetector,
)


@dataclass
class HostLoopRunner:
    """Drive an Experiment through a RobotBridge with failure handling.

    ``exp`` supplies the plan and absorb halves; ``bridge`` the command and
    observe surface. The watchdog objects are created with defaults when
    not given, and are all exercised by ``step``/``run``:

      * command failure or exception -> pause (+ log), heartbeat auto-recovers
      * ||dpose|| < stuck tol        -> force-direction escape command (+ log)
      * pause flag                   -> no motion commands until resume
      * save request                 -> surfaced to the caller via callback

    ``draws_fn(explr_step) -> TickDraws | None`` feeds the random draws of
    the plan and the absorb made at that step (tests feed the reference's);
    by default they come from the experiment's own generators.
    """

    exp: Experiment
    bridge: object
    # keyword-only: a positional third argument must not bind to a field
    # that was added later
    _: KW_ONLY
    pipeline: bool = True
    # with a bridge that offers the device-resident command-and-observe,
    # the pipelined step keeps the observation on the device; off forces
    # the host-side pipelined step
    device_fast: bool = True
    metrics: Optional[MetricsLog] = None
    stuck: StuckDetector = field(default_factory=StuckDetector)
    pause: Optional[PauseManager] = None
    heartbeat: RecoveryHeartbeat = field(
        default_factory=lambda: RecoveryHeartbeat(period_s=5.0, timeout_s=0.5))
    seeker: GoalSeeker = field(default_factory=GoalSeeker)
    killer: Optional[GracefulKiller] = None
    save_fn: Optional[object] = None  # callable(es) on save requests
    draws_fn: Optional[Callable[[int], Optional[TickDraws]]] = None
    events: list = field(default_factory=list)

    def __post_init__(self):
        # share the bridge's pause manager so panel/bridge/watchdog agree
        if self.pause is None:
            self.pause = getattr(self.bridge, "pause", None) or PauseManager()
        if self.metrics is None:
            self.metrics = MetricsLog(None, echo=False)
        self._obs = None  # last sensed (pose6, vel6, force, img), host-side
        self._pending = None  # pipelined (pstate, info, cmd7, its HostCopy or None)
        self._prev_small = None  # device-resident step: the deferred watchdog slice
        # the last absorb's tick info (``absorb_step``'s: the absorbed plan's
        # ergodic cost, the robot state, ...), out of any graph's memory;
        # and the plan the last step made, (pstate, info, cmd7), whether it
        # is pending or a stuck hit dropped it (after a replay, the step
        # graph's buffers, which the next replay overwrites)
        self.last_info = self.last_plan = None
        # the fork every plan runs on, made on the first plan (_fork_parts)
        self._fork_memory = self._fork_generator = None
        # the plan from a host observation and the runner's step as captured
        # graphs on the card, in the experiment's memory pool; None on the
        # CPU (tests may set them)
        pool = self.exp.graph_pool
        self.plan_graph = StepGraph(pool=pool) if pool is not None else None
        self.step_graph = StepGraph(pool=pool) if pool is not None else None
        self._fast = bool(self.pipeline) and bool(self.device_fast) and bool(
            getattr(self.bridge, "device_fast_path_ok", lambda: False)())
        self._cmd_absorb_plan = None
        if self._fast:
            from ..hw.bridge import SyntheticBridge

            self._nf = int(getattr(self.bridge, "_force_size", 1))
            self._img_shape = tuple(self.bridge._img_shape)
            # command, observe, absorb and plan in one step form, composed
            # from the bridge's pure command-and-observe, unless a subclass
            # or the instance customizes cmd_observe_device (which must
            # then stay in the loop)
            pure = getattr(self.bridge, "cmd_observe_pure", None)
            if pure is not None and (
                    type(self.bridge).cmd_observe_device
                    is not SyntheticBridge.cmd_observe_device
                    or "cmd_observe_device" in self.bridge.__dict__):
                pure = None
            if pure is not None:
                def _cmd_absorb_plan(es, pstate, info, env_s, cmd7, draws=(None, None),
                                     host=None):
                    tracing.begin("arm")
                    env_s2, flat, small = pure(env_s, cmd7)
                    tracing.end("arm")
                    es, pstate2, cmd7n, info2, tick_info = self._absorb_plan_flat(
                        es, pstate, info, flat, draws, host)
                    return es, pstate2, cmd7n, info2, tick_info, env_s2, small

                self._cmd_absorb_plan = _cmd_absorb_plan

    # ------------------------------------------------------------------
    # the runner's fork of the planner's state
    def _fork_parts(self, pstate):
        """The fork's ring and generator, made like the planner's on the
        first plan."""
        if self._fork_memory is None:
            m = pstate.memory
            self._fork_memory = dataclasses.replace(
                m, **{f.name: getattr(m, f.name).clone() for f in dataclasses.fields(m)})
            self._fork_generator = torch.Generator(device=pstate.gen.device)
        return self._fork_memory, self._fork_generator

    def _fork(self, pstate):
        """``pstate`` (the planner's or a baseline's) on the fork, for a plan
        that may go unused: its ring copied into the fork's ring in place
        (a push writes the ring's row and counters in place), the fork's
        generator in place of its own. Device copies only, so a captured
        step holds them; the generator's state is set on the host
        (``_seed_fork``)."""
        fm, gen = self._fork_parts(pstate)
        for f in dataclasses.fields(fm):
            getattr(fm, f.name).copy_(getattr(pstate.memory, f.name))
        return dataclasses.replace(pstate, memory=fm, gen=gen)

    def _seed_fork(self, es: ExperimentState):
        """Before a plan from the experiment's state: the fork's generator
        takes the planner's generator's state (a host copy of its seed and
        offset; a graph that registered the fork's generator reads it at
        its next replay)."""
        self._fork_parts(es.pstate)[1].set_state(es.pstate.gen.get_state())

    @staticmethod
    def _adopt(es: ExperimentState, pstate):
        """The plan ``pstate``, made on the fork, as the experiment's
        planner state: its ring copied into the experiment's ring in place,
        and the experiment's generator, whose state the caller sets to the
        fork's as it was after this plan."""
        mine = es.pstate.memory
        for f in dataclasses.fields(mine):
            getattr(mine, f.name).copy_(getattr(pstate.memory, f.name))
        return dataclasses.replace(pstate, memory=mine, gen=es.pstate.gen)

    # ------------------------------------------------------------------
    # the plan and absorb halves, on device tensors
    def _draws(self, explr_step: int):
        return self.draws_fn(explr_step) if self.draws_fn is not None else None

    def _dev(self, *values):
        """Host values (numpy, floats) or tensors as f32 tensors on the
        experiment's device: one conversion per observation."""
        dev = self.exp.device
        return [(v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v, np.float32)))
                .to(device=dev, dtype=torch.float32) for v in values]

    def _dev_obs(self, pose6, vel6, force, img):
        """A host observation as the absorb's device tensors (pose6, vel6,
        brightness, image, force); the absorb takes a one-element force, a
        wrench's norm."""
        f = np.asarray(force, np.float32).ravel()
        if f.size > 1:
            f = np.array([np.linalg.norm(f)], np.float32)
        elif not f.size:
            f = np.zeros(1, np.float32)
        return self._dev(pose6, vel6, self._brightness(pose6), img, f)

    def _plan_cmd7(self, es, pose6, vel6, b, draws=None):
        """Plan from an observed (pose6, vel6, brightness) on the fork of the
        planner's state, ``draws`` fed. The fork's generator must hold the
        state to draw from. The one definition of the packed command: cmd7 =
        [vel6 | brightness, -1 = keep the current one]."""
        exp = self.exp
        full_state = exp.explored.measured_obs(pose6, vel6, b)
        fork = dataclasses.replace(es, pstate=self._fork(es.pstate))
        pstate, vel6_cmd, b_cmd, info = exp.plan_step(fork, full_state, draws)
        tail = vel6_cmd.new_full((1,), -1.0) if b_cmd is None else b_cmd.reshape(1)
        cmd7 = torch.cat([vel6_cmd, tail])
        # plan_step opens ``env`` at the command, which the bridge executes
        # in another step: the span ends with the command's conversion
        tracing.end("env")
        return pstate, cmd7, info

    def _plan_obs(self, es, obs):
        """A plan from a host observation (the first step, after a drop, or
        every serial step)."""
        pose6, vel6 = obs[0], obs[1]
        return self._prime(es, self._dev(pose6, vel6, self._brightness(pose6)))

    def _prime(self, es, inputs):
        """A plan from the observation ``inputs`` (pose6, vel6, brightness on
        the device), the fork seeded from the planner, as one captured step
        through ``plan_graph`` where the runner has one; its carry (the
        experiment's tick carry) stays as it was. Returns (pstate, cmd7,
        info)."""
        tracing.count("prime")
        self._seed_fork(es)
        staged = (inputs, self._draws(es.explr_step))

        def run(es, staged):
            return es, self._plan_cmd7(es, *staged[0], staged[1])

        if self.plan_graph is None:
            plan = run(es, staged)[1]
        else:
            exp = self.exp
            plan = run_step(self.plan_graph, es, exp._carry, exp._with_carry, self._base,
                            (es.explr_step < exp.cfg.prior_steps,), staged, run,
                            [self._fork_generator])[1]
        pstate, cmd7, info = plan
        self.last_plan = (pstate, info, cmd7)
        return plan

    def _absorb(self, es, pstate, info, pose6, vel6, b, img, force, draws=None, host=None):
        """Adopt the plan and absorb the observation (``absorb_step``;
        ``host`` stages the host values)."""
        robot_state = self.exp.explored.measured_obs(pose6, vel6, b)[: self.exp.cfg.s_dim]
        return self.exp.absorb_step(es, self._adopt(es, pstate), info, robot_state, img,
                                    force, draws, host=host)

    def _absorb_plan(self, es, pstate, info, pose6, vel6, b, img, force,
                     plan_pose6, plan_vel6, plan_b, draws=(None, None), host=None):
        """Absorb step t, then plan step t+1 from ``plan_*``: on bridges
        with a live loop the freshest ring state, else the same
        observation. ``draws`` feeds the absorb's and the plan's."""
        es, tick_info = self._absorb(es, pstate, info, pose6, vel6, b, img, force, draws[0],
                                     host)
        pstate2, cmd7, info2 = self._plan_cmd7(es, plan_pose6, plan_vel6, plan_b, draws[1])
        return es, pstate2, cmd7, info2, tick_info

    def _absorb_plan_flat(self, es, pstate, info, flat, draws=(None, None), host=None):
        """``_absorb_plan`` on the packed observation (pose6, vel6, force,
        brightness, image), which stays on the device; the absorb gets the
        whole force slice (a wrench reduces to its norm there)."""
        nf = self._nf
        pose6, vel6, force, b = flat[:6], flat[6:12], flat[12:12 + nf], flat[12 + nf]
        img = flat[13 + nf:].reshape(self._img_shape)
        return self._absorb_plan(es, pstate, info, pose6, vel6, b, img, force,
                                 pose6, vel6, b, draws, host)

    def _step_absorb_plan(self, es, pending, env_s=None, inputs=(), plan=True):
        """One absorb of the pending plan ``(pstate, info, cmd7)`` and, with
        ``plan``, plan of the next step, as one captured step through
        ``step_graph`` where the runner has one. With the bridge's env
        state ``env_s``, the composed device-resident step (command the
        pending cmd7 and observe first); else ``inputs`` is the
        observation, the packed one ``(flat,)`` or the host one's tensors
        (absorbed, then planned from; without ``plan``, the serial step,
        only absorbed, and the pending plan stays). The draws of both
        halves are staged. Returns (es, the new pending ``(pstate, info,
        cmd7)``, the new env state, the new cmd7 (out of a graph's memory),
        the watchdog slice or None); the experiment's planner generator
        adopts the pending plan's."""
        exp = self.exp
        adopted = self._fork_generator.get_state()  # after the pending plan
        draws = (self._draws(es.explr_step), self._draws(es.explr_step + 1) if plan else None)
        host = None

        def run(state, staged):
            es, (pstate, info, cmd7), env_s = state
            inputs, draws = staged
            small = None
            if env_s is not None:
                (es, pstate, cmd7, info, tick_info, env_s,
                 small) = self._cmd_absorb_plan(es, pstate, info, env_s, cmd7, draws, host)
            elif not plan:
                es, tick_info = self._absorb(es, pstate, info, *inputs, draws[0], host)
            elif len(inputs) == 1:
                es, pstate, cmd7, info, tick_info = self._absorb_plan_flat(
                    es, pstate, info, *inputs, draws, host)
            else:
                es, pstate, cmd7, info, tick_info = self._absorb_plan(
                    es, pstate, info, *inputs, draws, host)
            return (es, (pstate, info, cmd7), env_s), (cmd7, small, tick_info)

        state = (es, pending, env_s)
        if self.step_graph is None:
            (es, pending, env_s), (cmd7n, small, tick_info) = run(state, (inputs, draws))
        else:
            pattern = self._pattern(es, env_s, plan)
            host = exp._stage(es, pattern[0])
            view, (cmd7n, small, tick_info) = run_step(
                self.step_graph, state, self._carry, self._with_carry,
                lambda state, carry: self._base(state[0], carry), pattern, (inputs, draws),
                run, [es.gen, self._fork_generator])
            exp._take(es, view[0], sum(pattern[0]))
            es.explr_step += 1
            pending, env_s = view[1], None if view[2] is None else advance_env(view[2], 1)
        es.pstate.gen.set_state(adopted)
        self.last_info = tick_info
        if plan:
            self.last_plan = pending
        return es, pending, env_s, cmd7n, small

    def _pattern(self, es, env_s, plan=True) -> tuple:
        """The host values an absorb-and-plan step from ``es`` branches on:
        which trainer calls the absorb makes, whether the next plan (with
        ``plan``) targets the prior, which of the step's one velocity
        command corrects the arm's drift (the composed step's, on the
        bridge's env state ``env_s``), whether the plan sends a
        brightness."""
        exp = self.exp
        return (exp._throttle(es.explr_step, es.learning_ind),
                plan and es.explr_step + 1 < exp.cfg.prior_steps,
                drift_key(getattr(self.bridge, "env", None), env_s, 1),
                exp.explored.b_pos >= 0)

    def _base(self, es, carry) -> tuple:
        """The base key of the runner's captured steps from ``es``: the
        experiment's (``Experiment._base``), the fork's generator and its
        ring's tensors by address, which every plan reads in place."""
        fork = self._fork_memory
        return (*self.exp._base(es, carry), self._fork_generator,
                _addresses(getattr(fork, f.name) for f in dataclasses.fields(fork)))

    def _carry(self, state) -> tuple:
        """What an absorb-and-plan step replaces: the experiment's tick carry
        (``Experiment._carry``), the pending plan (its state but the fork's
        generator, its info and cmd7) and the bridge's env state but the
        arm's host counter (or None)."""
        es, (pstate, info, cmd7), env_s = state
        return (self.exp._carry(es), *sim_carry(pstate, env_s), info, cmd7)

    def _with_carry(self, state, carry) -> tuple:
        """A view of ``state`` holding ``carry``, with its host values."""
        es, (pstate, _, _), env_s = state
        pstate, env_s = with_sim_carry(pstate, env_s, carry[1:3])
        return self.exp._with_carry(es, carry[0]), (pstate, *carry[3:]), env_s

    # ------------------------------------------------------------------
    def hooks(self) -> ControlHooks:
        """ControlHooks for a ControlPanel driving this runner."""
        return ControlHooks(
            pause_mgr=self.pause,
            reset_fn=self.bridge.reset,
            recover_fn=self._recover,
            switch_mode_fn=self.bridge.switch_controller,
        )

    def _log(self, kind: str, msg: str):
        self.events.append(kind)
        self.metrics.write_to_log(f"[{kind}] {msg}")

    def _drop_pipeline(self):
        self._obs = None  # the pose may have moved: re-sense before planning
        self._pending = None  # any in-flight plan is stale
        self._prev_small = None  # the deferred watchdog slice too

    def _recover(self):
        """Recovery escalation: clear controllers, re-level (random_listener
        parity: ErrorRecoveryActionGoal + EE re-align)."""
        tracing.count("recover")
        self.bridge.reset()
        self._drop_pipeline()
        self._log("recover", "bridge reset + controller re-arm")

    # ------------------------------------------------------------------
    def drive_to_start(self, goal_pose6, yaw_index: Optional[int] = None):
        """Goal-seek retry loop to the start pose (check_goal_pos parity):
        pose commands with retries, joint/controller reset at half budget,
        yaw-unstick nudges. Returns (reached, final_pose)."""

        def attempt(goal):
            self.bridge.klerg_pose(np.asarray(goal))
            return np.asarray(self.bridge.observe()[0])

        ok, pos = self.seeker.seek(np.asarray(goal_pose6), attempt, reset_fn=self._recover,
                                   yaw_index=yaw_index)
        self._drop_pipeline()
        if not ok:
            self._log("goal_seek_failed",
                      f"goal {np.round(np.asarray(goal_pose6), 3)} "
                      f"reached {np.round(pos, 3)}")
        return ok, pos

    # ------------------------------------------------------------------
    def step(self, es: ExperimentState) -> ExperimentState:
        """One explore+learn step through the bridge with failure handling:
        one tick of the tracer (host and device ``tick``; the ``drift``
        counter from the arm's command counter)."""
        with tracing.tick():
            tracing.begin("tick")
            env0 = getattr(self.bridge, "state", None) if tracing.state() is not None else None
            es = self._step(es)
            if env0 is not None:
                tracing.count("drift", self._drift_count(env0))
            tracing.end("tick")
        return es

    def _drift_count(self, env0) -> int:
        """The arm's drift corrections since its state ``env0`` (0 off the
        arm): one at each command whose count is a multiple of
        ``drift_every``."""
        n = getattr(self.bridge.state, "count", 0) - getattr(env0, "count", 0)
        return sum(drift_key(getattr(self.bridge, "env", None), env0, n)) if n > 0 else 0

    def _step(self, es: ExperimentState) -> ExperimentState:
        self.heartbeat.tick(self.pause, recover_fn=self._recover)
        if self.pause.paused or self.pause.manual:
            # the operator may move the robot while paused/manual: any
            # in-flight plan (and the frame it came from) is stale
            self._drop_pipeline()
            return es  # no motion while paused/manual (sensor_utils :556-578)

        if self._fast:
            return self._step_fast(es)

        if self.pipeline and self._pending is not None:
            # steady state: the plan came with the previous absorb, and its
            # host copy has been in flight since
            pstate, info, cmd7_dev, cmd_copy = self._pending
            self._pending = None
            cmd7 = cmd_copy.numpy()
        else:
            # prime (first step, or after recover/goal-seek/pause): plan from
            # the latest camera-synced observation, as the serial step does
            if self._obs is None:
                self._obs = self.bridge.observe()
            pstate, cmd7_dev, info = self._plan_obs(es, self._obs)
            cmd7 = cmd7_dev.cpu().numpy()

        try:
            ok = self.bridge.klerg_cmd(cmd7[:6], float(cmd7[6]))
        except Exception as e:  # service-exception parity (:153-166)
            ok = False
            self._log("cmd_error", repr(e))
        if not ok:
            self.pause.pause()
            self._log("cmd_failed", "velocity command rejected; pausing")
            return es

        pose2, vel2, force2, img2 = self.bridge.observe()

        # stuck detection + force-direction escape (check_cmd parity)
        with tracing.span("watchdog"):
            moved_ok, escape = self.stuck.check(pose2, force=self._escape_force(force2))
            if not moved_ok:
                tracing.count("stuck")
                if escape is not None:
                    self._escape(escape, pose2)
                    pose2, vel2, force2, img2 = self.bridge.observe()
                else:
                    self.bridge.reset()
                    self._log("stuck_reset", "no force reading; controller reset")

        obs = self._dev_obs(pose2, vel2, force2, img2)
        if self.pipeline:
            # the next step's plan follows this absorb; on a live-loop
            # bridge it takes the freshest ring state
            plan_pose, plan_vel = pose2, vel2
            fresh = getattr(self.bridge, "state_latest", None)
            if fresh is not None:
                latest = fresh()
                if latest is not None:
                    plan_pose, plan_vel = latest
            es, pending, _, cmd7_next, _ = self._step_absorb_plan(
                es, (pstate, info, cmd7_dev),
                inputs=(*obs, *self._dev(plan_pose, plan_vel, self._brightness(plan_pose))))
            self._pending = (*pending, HostCopy(cmd7_next))
        else:
            es, *_ = self._step_absorb_plan(es, (pstate, info, cmd7_dev), inputs=obs,
                                            plan=False)
        self._obs = (pose2, vel2, force2, img2)
        self._maybe_save(es)
        return es

    def run(self, es: ExperimentState, n_steps: int) -> ExperimentState:
        """Run n steps, honoring SIGINT/SIGTERM via GracefulKiller."""
        killer = self.killer or GracefulKiller(install=False)
        for _ in range(n_steps):
            if killer.kill_now:
                self._log("killed", "graceful shutdown requested")
                break
            es = self.step(es)
        # the device-resident step holds the last step's watchdog slice:
        # check it, so every absorbed frame is checked when run() returns
        small, self._prev_small = self._prev_small, None
        if small is not None:
            self._check_watchdog(small)
        return es

    # ------------------------------------------------------------------
    def _step_fast(self, es: ExperimentState) -> ExperimentState:
        """Device-resident pipelined step: the command and the packed
        observation stay on the device; only the watchdog slice is copied
        to the host, and it is checked a step later."""
        if self._pending is None:
            # prime (first step, or after recover/goal-seek/pause/stuck):
            # plan from a fresh host observation, as the other steps do
            if self._obs is None:
                self._obs = self.bridge.observe()
            pstate, cmd7, info = self._plan_obs(es, self._obs)
            cmd_copy = None
        else:
            pstate, info, cmd7, cmd_copy = self._pending
            self._pending = None

        if self._cmd_absorb_plan is not None:
            # re-check pause right before commanding: a panel or heartbeat
            # thread may have paused mid-step (klerg_cmd parity)
            if self.pause.paused:
                self._log("cmd_failed", "velocity command rejected; pausing")
                self._obs = None
                self._prev_small = None  # post-pause state is stale
                return es
            try:
                es, pending, env_s2, _, small = self._step_absorb_plan(
                    es, (pstate, info, cmd7), self.bridge.state)
            except CaptureError:
                raise  # a failed capture is the program's fault, not the robot's
            except Exception as e:  # service-exception parity (:153-166)
                self.pause.pause()
                self._log("cmd_error", repr(e))
                self._log("cmd_failed", "velocity command rejected; pausing")
                self._obs = None
                self._prev_small = None
                return es
            self.bridge.state = env_s2
            self._pending = (*pending, None)
            self._obs = None
            # deferred watchdog: check the previous step's slice, whose copy
            # has landed while this step was queued, and hold this one; a
            # stuck hit is acted on one frame later (the reference's
            # check_cmd also checks the previous iteration's state)
            small, self._prev_small = self._prev_small, HostCopy(small)
        else:
            cmd7_h = cmd_copy.numpy() if cmd_copy is not None else cmd7.cpu().numpy()
            try:
                res = self.bridge.cmd_observe_device(cmd7_h)
            except Exception as e:  # service-exception parity (:153-166)
                res = None
                self._log("cmd_error", repr(e))
            if res is None:
                self.pause.pause()
                self._log("cmd_failed", "velocity command rejected; pausing")
                self._obs = None
                return es
            flat, small = res
            es, pending, _, cmd7_next, _ = self._step_absorb_plan(es, (pstate, info, cmd7),
                                                                  inputs=(flat,))
            self._pending = (*pending, HostCopy(cmd7_next))
            self._obs = None  # this step never holds a host-side image

        if small is not None:
            self._check_watchdog(small)
        self._maybe_save(es)
        return es

    def _check_watchdog(self, small: HostCopy):
        """Stuck detection + escape on a watchdog slice, the tracer's host
        span ``watchdog``. On a hit the pipeline is dropped, so the next
        step primes from a post-escape observation; unlike the host-side
        check (escape before the absorb), the wedged frame was already
        absorbed (in the deferred form, up to two frames)."""
        with tracing.span("watchdog"):
            small_h = small.numpy()
            pose2 = small_h[:6]
            force2 = small_h[12:12 + self._nf]
            moved_ok, escape = self.stuck.check(pose2, force=self._escape_force(force2))
            if moved_ok:
                return
            tracing.count("stuck")
            self._pending = None
            self._prev_small = None  # a held slice predates the escape
            if escape is not None:
                self._escape(escape, pose2)
            else:
                self.bridge.reset()
                self._log("stuck_reset", "no force reading; controller reset")

    def _escape(self, escape, pose2):
        """Command the escape twist along the force direction and log it."""
        tracing.count("escape")
        esc6 = np.zeros(6)
        esc6[:3] = escape[:3] if escape.shape[0] >= 3 else np.pad(
            escape, (0, 3 - escape.shape[0]))
        try:
            self.bridge.klerg_cmd(esc6, -1.0)
        except Exception as e:
            self._log("cmd_error", repr(e))
        self._log("stuck_escape", f"pose {np.round(np.asarray(pose2)[:3], 4)} "
                                  f"escape {np.round(esc6[:3], 4)}")

    def _maybe_save(self, es):
        if self.pause.consume_save() and self.save_fn is not None:
            self.save_fn(es)
            self._log("save", f"checkpoint at step {es.explr_step}")

    # ------------------------------------------------------------------
    def _brightness(self, pose6):
        lb = getattr(self.bridge, "last_brightness", None)
        if lb is not None:  # cached at observe() time
            return float(lb)
        # NativeBridge: the brightness applied to the lamp/camera comes back
        # from the BrightnessNode (the reference syncs the published
        # /usb_cam/brightness into the state, sensor_utils.py:479-547)
        bn = getattr(self.bridge, "brightness_node", None)
        if bn is not None:
            return float(bn.current)
        st = getattr(self.bridge, "state", None)
        if st is not None and hasattr(st, "brightness"):
            return float(st.brightness)
        return 1.0

    @staticmethod
    def _escape_force(force):
        f = np.asarray(force, np.float64).ravel()
        if f.size >= 3:
            return f[:3]
        # scalar force magnitude: no direction -> escape straight up
        # (the pose-guard z lift of cartesian_pose_interface.cpp:138-147)
        return np.array([0.0, 0.0, float(f[0]) if f.size else 0.0])

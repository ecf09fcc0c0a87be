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
each plan runs on a fork of the planner's state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import KW_ONLY, dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.host_copy import HostCopy
from .agent import Experiment, ExperimentState, TickDraws
from .metrics import MetricsLog
from .panel import ControlHooks
from .watchdog import (
    GoalSeeker,
    GracefulKiller,
    PauseManager,
    RecoveryHeartbeat,
    StuckDetector,
)


def _fork(pstate):
    """The planner's (or a baseline's) state for a plan that may go unused:
    its trajectory ring and random generator are copies (a push writes the
    ring's row and counters in place)."""
    gen = torch.Generator(device=pstate.gen.device)
    gen.set_state(pstate.gen.get_state())
    m = pstate.memory
    memory = dataclasses.replace(m, **{f.name: getattr(m, f.name).clone()
                                       for f in dataclasses.fields(m)})
    return dataclasses.replace(pstate, memory=memory, gen=gen)


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
                def _cmd_absorb_plan(es, pstate, info, env_s, cmd7):
                    env_s2, flat, small = pure(env_s, cmd7)
                    es, pstate2, cmd7n, info2, tick_info = self._absorb_plan_flat(
                        es, pstate, info, flat)
                    return es, pstate2, cmd7n, info2, tick_info, env_s2, small

                self._cmd_absorb_plan = _cmd_absorb_plan

    # ------------------------------------------------------------------
    # the plan and absorb halves, on device tensors
    def _draws(self, es: ExperimentState):
        return self.draws_fn(es.explr_step) if self.draws_fn is not None else None

    def _dev(self, *values):
        """Host values (numpy, floats) or tensors as f32 tensors on the
        experiment's device: one conversion per observation."""
        dev = self.exp.device
        return [(v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v, np.float32)))
                .to(device=dev, dtype=torch.float32) for v in values]

    def _plan_cmd7(self, es, pose6, vel6, b):
        """Plan from an observed (pose6, vel6, brightness), on a fork of the
        planner's state. The one definition of the packed command: cmd7 =
        [vel6 | brightness, -1 = keep the current one]."""
        exp = self.exp
        full_state = exp.explored.measured_obs(pose6, vel6, b)
        fork = dataclasses.replace(es, pstate=_fork(es.pstate))
        pstate, vel6_cmd, b_cmd, info = exp.plan_step(fork, full_state, self._draws(es),
                                                      graph=False)
        tail = vel6_cmd.new_full((1,), -1.0) if b_cmd is None else b_cmd.reshape(1)
        return pstate, torch.cat([vel6_cmd, tail]), info

    def _plan_obs(self, es, obs):
        pose6, vel6 = obs[0], obs[1]
        return self._plan_cmd7(es, *self._dev(pose6, vel6, self._brightness(pose6)))

    def _absorb(self, es, pstate, info, pose6, vel6, b, img, force):
        robot_state = self.exp.explored.measured_obs(pose6, vel6, b)[: self.exp.cfg.s_dim]
        return self.exp.absorb_step(es, pstate, info, robot_state, img, force,
                                    self._draws(es))

    def _absorb_plan(self, es, pstate, info, pose6, vel6, b, img, force,
                     plan_pose6, plan_vel6, plan_b):
        """Absorb step t, then plan step t+1 from ``plan_*``: on bridges
        with a live loop the freshest ring state, else the same
        observation."""
        es, tick_info = self._absorb(es, pstate, info, pose6, vel6, b, img, force)
        pstate2, cmd7, info2 = self._plan_cmd7(es, plan_pose6, plan_vel6, plan_b)
        return es, pstate2, cmd7, info2, tick_info

    def _absorb_plan_flat(self, es, pstate, info, flat):
        """``_absorb_plan`` on the packed observation (pose6, vel6, force,
        brightness, image), which stays on the device; the absorb gets the
        whole force slice (a wrench reduces to its norm there)."""
        nf = self._nf
        pose6, vel6, force, b = flat[:6], flat[6:12], flat[12:12 + nf], flat[12 + nf]
        img = flat[13 + nf:].reshape(self._img_shape)
        return self._absorb_plan(es, pstate, info, pose6, vel6, b, img, force,
                                 pose6, vel6, b)

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
        """One explore+learn step through the bridge with failure handling."""
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
            pstate, info, _, cmd_copy = self._pending
            self._pending = None
            cmd7 = cmd_copy.numpy()
        else:
            # prime (first step, or after recover/goal-seek/pause): plan from
            # the latest camera-synced observation, as the serial step does
            if self._obs is None:
                self._obs = self.bridge.observe()
            pstate, cmd7, info = self._plan_obs(es, self._obs)
            cmd7 = cmd7.cpu().numpy()

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
        moved_ok, escape = self.stuck.check(pose2, force=self._escape_force(force2))
        if not moved_ok:
            if escape is not None:
                self._escape(escape, pose2)
                pose2, vel2, force2, img2 = self.bridge.observe()
            else:
                self.bridge.reset()
                self._log("stuck_reset", "no force reading; controller reset")

        # the absorb takes a one-element force: a wrench's norm
        f = np.asarray(force2, np.float32).ravel()
        if f.size > 1:
            f = np.array([np.linalg.norm(f)], np.float32)
        elif not f.size:
            f = np.zeros(1, np.float32)
        obs = self._dev(pose2, vel2, self._brightness(pose2), img2, f)
        if self.pipeline:
            # the next step's plan follows this absorb; on a live-loop
            # bridge it takes the freshest ring state
            plan_pose, plan_vel = pose2, vel2
            fresh = getattr(self.bridge, "state_latest", None)
            if fresh is not None:
                latest = fresh()
                if latest is not None:
                    plan_pose, plan_vel = latest
            es, pstate2, cmd7_next, info2, _ = self._absorb_plan(
                es, pstate, info, *obs,
                *self._dev(plan_pose, plan_vel, self._brightness(plan_pose)))
            self._pending = (pstate2, info2, cmd7_next, HostCopy(cmd7_next))
        else:
            es, _ = self._absorb(es, pstate, info, *obs)
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
                (es, pstate2, cmd7_next, info2, _tick_info, env_s2,
                 small) = self._cmd_absorb_plan(es, pstate, info, self.bridge.state, cmd7)
            except Exception as e:  # service-exception parity (:153-166)
                self.pause.pause()
                self._log("cmd_error", repr(e))
                self._log("cmd_failed", "velocity command rejected; pausing")
                self._obs = None
                self._prev_small = None
                return es
            self.bridge.state = env_s2
            self._pending = (pstate2, info2, cmd7_next, None)
            self._obs = None
            # deferred watchdog: check the previous step's slice, whose copy
            # has landed while this step was queued, and hold this one; a
            # stuck hit is acted on one frame later (the reference's
            # check_cmd also checks the previous iteration's state)
            small, self._prev_small = self._prev_small, HostCopy(small)
        else:
            cmd7 = cmd_copy.numpy() if cmd_copy is not None else cmd7.cpu().numpy()
            try:
                res = self.bridge.cmd_observe_device(cmd7)
            except Exception as e:  # service-exception parity (:153-166)
                res = None
                self._log("cmd_error", repr(e))
            if res is None:
                self.pause.pause()
                self._log("cmd_failed", "velocity command rejected; pausing")
                self._obs = None
                return es
            flat, small = res
            es, pstate2, cmd7_next, info2, _ = self._absorb_plan_flat(es, pstate, info, flat)
            self._pending = (pstate2, info2, cmd7_next, HostCopy(cmd7_next))
            self._obs = None  # this step never holds a host-side image

        if small is not None:
            self._check_watchdog(small)
        self._maybe_save(es)
        return es

    def _check_watchdog(self, small: HostCopy):
        """Stuck detection + escape on a watchdog slice. On a hit the
        pipeline is dropped, so the next step primes from a post-escape
        observation; unlike the host-side check (escape before the absorb),
        the wedged frame was already absorbed (in the deferred form, up to
        two frames)."""
        small_h = small.numpy()
        pose2 = small_h[:6]
        force2 = small_h[12:12 + self._nf]
        moved_ok, escape = self.stuck.check(pose2, force=self._escape_force(force2))
        if moved_ok:
            return
        self._pending = None
        self._prev_small = None  # a held slice predates the escape
        if escape is not None:
            self._escape(escape, pose2)
        else:
            self.bridge.reset()
            self._log("stuck_reset", "no force reading; controller reset")

    def _escape(self, escape, pose2):
        """Command the escape twist along the force direction and log it."""
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

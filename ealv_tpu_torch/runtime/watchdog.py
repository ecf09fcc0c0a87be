"""Failure detection and recovery, the host-side safety layer: a
numpy-only copy of ``ealv_tpu/runtime/watchdog.py``.

Parity targets (SURVEY.md §5 "failure detection"):
  - stuck-pose detection by ||dx|| < 1e-5 with force-direction escape
    (sensor_utils.check_cmd :444-457, vel_move_force_norm :460-476),
  - pause/resume/manual flags (sensor_utils :556-578),
  - the goal-seek retry loop with joint reset + yaw unstick
    (check_goal_pos :375-441),
  - GracefulKiller SIGINT/SIGTERM handling (dist_modules/utils.py:42-60),
  - the random_listener auto-recovery heartbeat (scripts/random_listener).

These guard the host loop around the device work (service errors, robot
faults); the device work itself needs none of it.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np


class GracefulKiller:
    """SIGINT/SIGTERM -> cooperative shutdown flag (utils.py:42-60)."""

    def __init__(self, install: bool = True):
        self.kill_now = False
        if install:
            signal.signal(signal.SIGINT, self._exit)
            signal.signal(signal.SIGTERM, self._exit)

    def _exit(self, signum, frame):
        self.kill_now = True


@dataclass
class StuckDetector:
    """Detects a non-moving end effector and proposes an escape command.

    ``check(pos, force)`` returns (ok, escape_vel or None): ok=False when the
    pose didn't move and an escape along the negative force direction should
    be commanded (check_cmd + vel_move_force_norm parity).
    """

    tol: float = 1e-5
    escape_speed: float = 0.05
    last_pos: np.ndarray | None = None

    def check(self, pos, force=None):
        pos = np.asarray(pos, np.float64)
        ok = True
        escape = None
        if self.last_pos is not None and np.linalg.norm(self.last_pos - pos) < self.tol:
            ok = False
            if force is not None and np.linalg.norm(force) > 1e-6:
                f = np.asarray(force, np.float64)
                escape = self.escape_speed * f / np.linalg.norm(f)
        self.last_pos = pos
        return ok, escape

    def reset(self):
        self.last_pos = None


@dataclass
class PauseManager:
    """pause/resume/manual/save request flags (the /pause //resume //manual
    topic surface, sensor_utils.py:556-578)."""

    paused: bool = False
    manual: bool = False
    save_requested: bool = False

    def pause(self):
        self.paused = True

    def resume(self):
        self.paused = False

    def request_save(self):
        self.save_requested = True

    def consume_save(self) -> bool:
        out = self.save_requested
        self.save_requested = False
        return out


@dataclass
class GoalSeeker:
    """Retry loop driving toward a goal pose with escalating recovery
    (check_goal_pos parity :375-441): retry -> yaw-unstick nudge -> report
    failure after max_tries.

    ``step_fn(goal) -> pos`` commands one attempt and returns the reached
    position; ``reset_fn()`` is the joint-reset escalation.
    """

    pos_tol: float = 0.02
    max_tries: int = 10
    yaw_nudge: float = 0.2

    def seek(self, goal, step_fn, reset_fn=None, yaw_index: int | None = None):
        goal = np.asarray(goal, np.float64)
        for attempt in range(self.max_tries):
            pos = np.asarray(step_fn(goal), np.float64)
            if np.linalg.norm(pos - goal) < self.pos_tol:
                return True, pos
            if attempt == self.max_tries // 2 and reset_fn is not None:
                reset_fn()
            if yaw_index is not None and attempt % 3 == 2:
                goal = goal.copy()
                goal[yaw_index] += self.yaw_nudge * (-1) ** attempt
        return False, pos


@dataclass
class RecoveryHeartbeat:
    """Periodic auto-resume + re-level heartbeat (random_listener parity):
    calls ``recover_fn`` when paused longer than ``timeout_s`` and emits a
    resume at ``period_s`` intervals."""

    period_s: float = 5.0
    timeout_s: float = 2.0
    _paused_since: float | None = None
    _last_beat: float = field(default_factory=time.monotonic)

    def tick(self, pause_mgr: PauseManager, recover_fn=None, resume_fn=None):
        now = time.monotonic()
        if pause_mgr.paused:
            if self._paused_since is None:
                self._paused_since = now
            elif recover_fn is not None and now - self._paused_since > self.timeout_s:
                recover_fn()
                pause_mgr.resume()
                self._paused_since = None
        else:
            self._paused_since = None
        if resume_fn is not None and now - self._last_beat > self.period_s:
            resume_fn()
            self._last_beat = now

"""The port's watchdog (``ealv_tpu_torch/runtime/watchdog.py``, numpy only)
against the JAX package's on the same inputs: the stuck detector's
verdicts and escapes over a pose/force sequence, the pause flags, the
goal-seek retry loop's attempts, resets and yaw nudges, the recovery
heartbeat's arm-then-fire, and the kill flag. Exact equality: both are the
same numpy code."""

import signal

import numpy as np
import pytest

from ealv_tpu.runtime import watchdog as jw
from ealv_tpu_torch.runtime import watchdog as tw


def test_stuck_detector_matches_jax():
    rng = np.random.default_rng(0)
    poses = [rng.uniform(-1, 1, 6)]
    for k in range(12):  # moves, tiny jitters under the tolerance, and holds
        step = [1e-2, 3e-6, 0.0][k % 3]
        poses.append(poses[-1] + step * rng.standard_normal(6))
    forces = [None, np.zeros(3), np.array([0.0, 0.0, 4.0]), rng.standard_normal(3),
              np.array([1e-8, 0, 0])]
    for tol in (1e-5, 1e9):
        dj, dt = jw.StuckDetector(tol=tol), tw.StuckDetector(tol=tol)
        for k, p in enumerate(poses):
            f = forces[k % len(forces)]
            (oj, ej), (ot, et) = dj.check(p, force=f), dt.check(p, force=f)
            assert oj == ot, k
            assert (ej is None) == (et is None), k
            if ej is not None:
                np.testing.assert_array_equal(et, ej)
                np.testing.assert_allclose(np.linalg.norm(et), dt.escape_speed)
        dt.reset()
        assert dt.last_pos is None and dt.check(poses[0])[0]


def test_pause_manager_flags():
    for mod in (jw, tw):
        pm = mod.PauseManager()
        pm.pause()
        assert pm.paused
        pm.resume()
        pm.request_save()
        assert not pm.paused and pm.consume_save() and not pm.consume_save()


@pytest.mark.parametrize("reach_at,yaw_index,max_tries", [(None, 5, 10), (4, 5, 10),
                                                          (None, None, 4), (0, 3, 3)])
def test_goal_seeker_matches_jax(reach_at, yaw_index, max_tries):
    """The goals each attempt commands (with the yaw nudges), the reset at
    half the budget, the verdict and the reached pose."""
    goal = np.array([0.5, 0.05, 0.35, 3.2, 0.0, 0.1])
    out = []
    for mod in (jw, tw):
        goals, resets = [], []

        def step_fn(g, goals=goals):
            goals.append(np.array(g))
            k = len(goals) - 1
            return g if reach_at is not None and k >= reach_at else g + 0.1

        ok, pos = mod.GoalSeeker(max_tries=max_tries).seek(
            goal, step_fn, reset_fn=lambda r=resets: r.append(len(goals)), yaw_index=yaw_index)
        out.append((ok, pos, goals, resets))
    (oj, pj, gj, rj), (ot, pt, gt, rt) = out
    assert oj == ot and rj == rt and len(gj) == len(gt)
    np.testing.assert_array_equal(pt, pj)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(a, b)


def test_recovery_heartbeat_matches_jax():
    """Timeout 0: the first paused tick arms, the second recovers and
    resumes; a periodic resume fires once the period has passed."""
    logs = []
    for mod in (jw, tw):
        hb = mod.RecoveryHeartbeat(period_s=0.0, timeout_s=0.0)
        pm = mod.PauseManager()
        log = []
        for k in range(5):
            if k in (0, 3):
                pm.pause()
            hb.tick(pm, recover_fn=lambda: log.append(("recover", k)),
                    resume_fn=lambda: log.append(("beat", k)))
            log.append(("paused", pm.paused))
        logs.append(log)
    assert logs[0] == logs[1]
    assert ("recover", 1) in logs[1] and ("recover", 4) in logs[1]


def test_graceful_killer_flag_and_handlers():
    k = tw.GracefulKiller(install=False)
    assert not k.kill_now
    k._exit(signal.SIGTERM, None)
    assert k.kill_now
    before = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        k2 = tw.GracefulKiller()
        assert signal.getsignal(signal.SIGTERM) == k2._exit
        assert signal.getsignal(signal.SIGINT) == k2._exit
    finally:
        for s, h in before.items():
            signal.signal(s, h)

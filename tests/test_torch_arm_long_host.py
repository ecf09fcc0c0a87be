"""The host loop on the arm re-synchronised along the long JAX runs of
``test_torch_arm_long``: at each checkpoint a JAX ``HostLoopRunner`` and
the port's start from the same state (the port's converted with
``experiment_state_from_jax``) over a plain ``SyntheticBridge`` on that
state's arm, in the mode the study CLIs use (pipelined, device-resident,
the watchdog one step late), and take four steps, the port with the JAX
draws keyed by the explored step (``test_torch_host_loop.jax_draws``).
Each step is compared: the stuck detector's input (the pose it is handed)
and its decision, the events logged, the counters, the arm's pose; at the
end the absorbed samples and the plan.

The checkpoints: the start, the first trainer call, the replay ring's
wrap, and the deepest contact on ``"arm-dynamic"`` (the contact guard
blocking). On ``"arm"`` from the start the first plans are zero, so the
arm stands still for a step and both loops log ``stuck_reset`` at the
same step: the recovery the port's arm study logged, and the JAX one
here, on the CPU.

Tolerances of ``test_torch_host_loop.py``: poses 1e-4, the absorbed
samples 1e-4, the plan rtol 2e-3 and atol 2e-4.
"""

import numpy as np
import pytest

from ealv_tpu.hw import bridge as jb
from ealv_tpu.runtime import HostLoopRunner as JRunner
from ealv_tpu.runtime.watchdog import RecoveryHeartbeat as JBeat
from ealv_tpu_torch.hw import bridge as tb
from ealv_tpu_torch.runtime import HostLoopRunner
from ealv_tpu_torch.runtime.watchdog import RecoveryHeartbeat
from ealv_tpu_torch.utils.convert import experiment_state_from_jax
from test_torch_arm_long import toy_run
from test_torch_host_loop import jax_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

N_STEPS = 4
POINTS = [("arm", "start"), ("arm", "first_train"), ("arm", "ring_wrap"),
          ("arm-dynamic", "deepest_contact")]


def watched(runner):
    """Record what the runner's stuck detector is handed and decides."""
    checks, check = [], runner.stuck.check

    def wrapped(pos, force=None):
        ok, escape = check(pos, force)
        checks.append((np.asarray(pos, np.float64).copy(), ok, escape is not None))
        return ok, escape

    runner.stuck.check = wrapped
    return checks


def drive(runner, es, bridge, on_step=None):
    log = []
    for _ in range(N_STEPS):
        es = runner.step(es)
        if on_step is not None:
            on_step(es)
        log.append(dict(events=list(runner.events), explr_step=int(es.explr_step),
                        learning_ind=int(es.learning_ind),
                        pose=np.asarray(bridge.state.pose).copy()))
    return runner.run(es, 0), log


@pytest.mark.parametrize("case,name", POINTS)
def test_host_loop_steps_resynchronised(case, name):
    run = toy_run(case)
    k, es_j, _, _ = run.checkpoints[name]
    exp_j, exp_t = run.exp, run.port()
    bj = jb.SyntheticBridge(exp_j.env, es_j.env)
    rj = JRunner(exp_j, bj, heartbeat=JBeat(period_s=100.0, timeout_s=0.0))
    checks_j = watched(rj)
    snaps = {int(es_j.explr_step): es_j}
    es_j, log_j = drive(rj, es_j, bj,
                        on_step=lambda es: snaps.setdefault(int(es.explr_step), es))

    es_t = experiment_state_from_jax(snaps[k], exp_t)
    bt = tb.SyntheticBridge(exp_t.env, es_t.env)
    rt = HostLoopRunner(exp_t, bt, heartbeat=RecoveryHeartbeat(period_s=100.0, timeout_s=0.0),
                        draws_fn=jax_draws(exp_j, snaps).get)
    assert rt._fast and rj._fast
    checks_t = watched(rt)
    es_t, log_t = drive(rt, es_t, bt)

    what = f"{case} {name} (tick {k})"
    assert len(checks_t) == len(checks_j), what
    for i, (a, b) in enumerate(zip(checks_t, checks_j)):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} stuck check {i} input")
        assert a[1:] == b[1:], f"{what} stuck check {i} decision"
    for i, (a, b) in enumerate(zip(log_t, log_j)):
        for key in ("events", "explr_step", "learning_ind"):
            assert a[key] == b[key], f"{what} step {i} {key}: {a[key]} != {b[key]}"
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{what} step {i} pose")
    assert rt.events == rj.events
    assert es_t.buf.total == int(es_j.buf.total) and es_t.buf.pos == int(es_j.buf.pos)
    for i in range(int(snaps[k].buf.total), es_t.buf.total):
        slot = i % es_t.buf.capacity
        for field in ("x", "y", "force"):
            np.testing.assert_allclose(getattr(es_t.buf, field)[slot].float().numpy(),
                                       np.asarray(getattr(es_j.buf, field)[slot]),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{what} {field} {i}")
    np.testing.assert_allclose(es_t.pstate.u.numpy(), np.asarray(es_j.pstate.u), rtol=2e-3,
                               atol=2e-4, err_msg=f"{what} plan u")
    if name == "start":
        # the zero first plans: the arm does not move, no force, a reset
        assert "stuck_reset" in rj.events and not checks_j[1][1]

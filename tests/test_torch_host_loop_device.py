"""The port's host loop in the device-resident mode against the JAX
runner's, step by step, on the scenario of ``test_torch_host_loop.py``
(the dynamic-contact arm in the wedge, a forced wedge, a pause the
heartbeat recovers, a save request) over a plain ``SyntheticBridge``: the
command, the packed observation and the absorb-and-plan stay on the
device, and the watchdog checks each step's slice one step later. Once
with the composed step (the bridge's ``cmd_observe_pure``), once with a
bridge that overrides ``cmd_observe_device``, which keeps its override in
the loop and checks each slice in its own step. Also the gate that picks
between them. Tolerances of ``test_torch_host_loop.py``.
"""

import numpy as np
import pytest

from ealv_tpu.hw import bridge as jb
from ealv_tpu.runtime import HostLoopRunner as JRunner
from ealv_tpu_torch.hw import bridge as tb
from ealv_tpu_torch.runtime import HostLoopRunner
from test_torch_host_loop import assert_step_matched, experiments, record
from test_torch_trainer import one_torch_thread  # noqa: F401


def custom(mod):
    class CustomDevice(mod.SyntheticBridge):
        def cmd_observe_device(self, cmd7):
            return super().cmd_observe_device(cmd7)

    return CustomDevice


BRIDGES = {"composed": lambda mod, env, state: mod.SyntheticBridge(env, state),
           "custom": lambda mod, env, state: custom(mod)(env, state)}


@pytest.fixture(scope="module")
def recordings():
    return {kind: record("device", make_bridge) for kind, make_bridge in BRIDGES.items()}


@pytest.mark.parametrize("kind", list(BRIDGES))
def test_device_scenario_step_matched(recordings, kind):
    rec = recordings[kind]
    assert rec["port"][4]._fast and rec["jax"][4]._fast
    assert (rec["port"][4]._cmd_absorb_plan is None) == (kind == "custom") == (
        rec["jax"][4]._cmd_absorb_plan is None)
    assert_step_matched(rec, cmds=False)


def test_deferred_watchdog(recordings):
    """With the stuck tolerance raised before steps 2 and 3, the custom
    bridge's loop checks each step's own slice and escapes twice. The
    composed step checks the previous step's slice: its hit at step 2
    drops the held slice and the in-flight plan, so step 3 primes a new
    plan and has no slice to check; one escape."""
    log_c, log_u = recordings["composed"]["port"][1], recordings["custom"]["port"][1]
    assert [s["events"].count("stuck_escape") for s in log_u[1:5]] == [0, 1, 2, 2]
    assert [s["events"].count("stuck_escape") for s in log_c[1:5]] == [0, 1, 1, 1]
    assert log_c[2]["pending"] and not log_c[3]["pending"]  # dropped, then primed
    assert log_u[2]["pending"] and log_u[3]["pending"] and not log_u[4]["pending"]


def test_pause_save_and_trajectory(recordings):
    """Both forms hold the arm while paused, recover through the
    heartbeat, serve the save in the step it was asked before, and check
    the last held slice when run() returns."""
    for kind in BRIDGES:
        es, log, saves, bridge, runner = recordings[kind]["port"]
        assert log[5]["paused"] and log[5]["explr_step"] == log[4]["explr_step"]
        np.testing.assert_array_equal(log[5]["pose"], log[4]["pose"])
        assert log[6]["events"][-1] == "recover" and not log[6]["paused"]
        assert saves == [log[7]["explr_step"]] and log[7]["events"][-1] == "save"
        assert runner._prev_small is None  # run() checked the held slice


def test_fast_path_gate_matches_jax():
    """The device-resident step needs a bridge that leaves klerg_cmd and
    observe alone; the composed form also needs cmd_observe_device left
    alone, in the class and on the instance."""
    exp_j, exp_t = experiments()
    es_j = exp_j.init(seed=21)
    es_t = exp_t.init(seed=21)

    class Wedged(tb.SyntheticBridge):
        def klerg_cmd(self, twist6, brightness=-1.0):
            return super().klerg_cmd(twist6, brightness)

    class JWedged(jb.SyntheticBridge):
        def klerg_cmd(self, twist6, brightness=-1.0):
            return super().klerg_cmd(twist6, brightness)

    cases = {"plain": (jb.SyntheticBridge, tb.SyntheticBridge),
             "custom": (custom(jb), custom(tb)), "wedged": (JWedged, Wedged)}
    for name, (jcls, tcls) in cases.items():
        for kw in (dict(), dict(device_fast=False), dict(pipeline=False)):
            rj = JRunner(exp_j, jcls(exp_j.env, es_j.env), **kw)
            rt = HostLoopRunner(exp_t, tcls(exp_t.env, es_t.env), **kw)
            assert (rt._fast, rt._cmd_absorb_plan is None) == (
                rj._fast, rj._cmd_absorb_plan is None), (name, kw)
    patched = tb.SyntheticBridge(exp_t.env, es_t.env)
    patched.cmd_observe_device = lambda cmd7: None
    rt = HostLoopRunner(exp_t, patched)
    assert rt._fast and rt._cmd_absorb_plan is None


def test_recover_clears_the_device_pipeline(recordings):
    runner = recordings["composed"]["port"][4]
    runner._pending, runner._prev_small = object(), object()
    runner._recover()
    assert runner._pending is None and runner._prev_small is None and runner._obs is None

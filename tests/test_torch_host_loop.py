"""The port's host-in-the-loop runtime (``ealv_tpu_torch/runtime/
host_loop.py``) against the JAX ``HostLoopRunner``, step by step, in the
serial and the host-pipelined modes; the device-resident mode is in
``test_torch_host_loop_device.py``.

Both runners drive the same toy experiment on the dynamic-contact arm,
started deep in the side of a wide cylinder (the wedge of
``tests/test_arm.py``), through the same scripted bridge: a forced wedge
(the stuck tolerance raised for two steps, so the escape along the contact
force fires), a pause that the heartbeat recovers, a save request, and one
rejected velocity command. The port gets the same weights, the JAX arm
state, and the JAX keys' random draws through ``draws_fn``, keyed by the
explored step. Each step is compared: the events logged, the step and
trainer counters, the pause flag, the pipeline's state, the bridge's
observations, the commands the bridge received and the arm's pose; at the
end the absorbed samples and the saves. Also goal seeking, the panel
hooks, the brightness read back, and the runner's keyword-only fields.

Tolerances: poses 1e-4 (the plan's rtol 2e-3 of test_torch_tick.py on a
0.04 s step), commands rtol 2e-3 and atol 2e-4 (the plan's), absorbed
poses and images 1e-4.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.hw import bridge as jb
from ealv_tpu.runtime import Experiment as JExperiment, HostLoopRunner as JRunner
from ealv_tpu.runtime.metrics import MetricsLog as JMetrics
from ealv_tpu.runtime.panel import ControlPanel as JPanel
from ealv_tpu.runtime.watchdog import RecoveryHeartbeat as JBeat
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.hw import bridge as tb
from ealv_tpu_torch.runtime import Experiment, HostLoopRunner, TickDraws
from ealv_tpu_torch.runtime.metrics import MetricsLog
from ealv_tpu_torch.runtime.panel import ControlPanel
from ealv_tpu_torch.runtime.watchdog import RecoveryHeartbeat
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import arm_state_from_jax, params_from_jax
from test_torch_arm import big_cylinder
from test_torch_trainer import jax_train_draws, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
            cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
            num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256, batch_size=8,
            num_learning_opt=2, compute_dtype="float32", sim_backend="arm-dynamic")
MODES = {"serial": dict(pipeline=False), "host": dict(pipeline=True, device_fast=False),
         "device": dict(pipeline=True)}
N_STEPS = 12


def scripted(base):
    """``base`` (a SyntheticBridge class) that records the commands it
    gets and counts its observations, and rejects the ``fail_at``-th
    command (0: none)."""

    class Scripted(base):
        def __init__(self, env, state, fail_at=0):
            super().__init__(env, state)
            self.cmds, self.n_obs, self.fail_at = [], 0, fail_at

        def klerg_cmd(self, twist6, brightness=-1.0):
            self.cmds.append(np.asarray(twist6, np.float64).copy())
            if len(self.cmds) == self.fail_at:
                return False
            return super().klerg_cmd(twist6, brightness)

        def observe(self):
            self.n_obs += 1
            return super().observe()

    return Scripted


def script(k, runner):
    """What happens before step k: a forced wedge over steps 2-3 (no motion
    counts as stuck), a pause at step 5 (the heartbeat recovers it at step
    6), a save request at step 7."""
    if k == 2:
        runner.stuck.tol = 1e9
    if k == 4:
        runner.stuck.tol = 1e-5
    if k == 5:
        runner.pause.pause()
    if k == 7:
        runner.pause.request_save()


def drive(runner, es, bridge, on_step=None, n_steps=N_STEPS):
    """Run the script; per step the runner's observable state, and
    ``on_step(es)`` after each step. Ends with ``run(es, 0)``, which checks
    a held watchdog slice."""
    saves, log = [], []
    runner.save_fn = lambda s: saves.append(int(s.explr_step))
    for k in range(n_steps):
        script(k, runner)
        es = runner.step(es)
        if on_step is not None:
            on_step(es)
        log.append(dict(events=list(runner.events), explr_step=int(es.explr_step),
                        learning_ind=int(es.learning_ind), paused=runner.pause.paused,
                        pending=runner._pending is None, obs=runner._obs is None,
                        pose=np.asarray(bridge.state.pose).copy(),
                        n_obs=getattr(bridge, "n_obs", 0),
                        cmds=len(getattr(bridge, "cmds", []))))
    es = runner.run(es, 0)
    return es, log, saves


def experiments():
    js, ts = big_cylinder()
    exp_j = JExperiment(JConfig(**TINY), train_calls_per_tick=1, scene=js)
    exp_t = Experiment(ExperimentConfig(**TINY), train_calls_per_tick=1, scene=ts, device="cpu")
    return exp_j, exp_t


def jax_draws(exp_j, snaps):
    """TickDraws per explored step from the JAX states seen at each step:
    the plan's samples and history draw from the planner's key at that
    step, the trainer's draws from the state's key and the ring after it."""
    cfg = exp_j.cfg

    @jax.jit
    def planner_draws(es):
        ps = exp_j.planner.save_update(es.pstate, exp_j._measured_robot_state(es.env), save=True)
        _, k_samp, k_hist = jax.random.split(ps.key, 3)
        lims = ps.lims
        samples = jax.random.uniform(k_samp, (cfg.num_target_samples, lims.shape[0]),
                                     minval=lims[:, 0], maxval=lims[:, 1])
        cap = ps.memory.capacity
        logw = jnp.where(jnp.arange(cap) < ps.memory.size, 0.0, -1e30)
        hist = jax.lax.top_k(logw + jax.random.gumbel(k_hist, (cap,)), cfg.num_traj_samples)[1]
        return samples, hist

    draws = {}
    for k, es in snaps.items():
        s, h = planner_draws(es)
        d = TickDraws(samples=torch.tensor(np.asarray(s)),
                      hist_idx=torch.tensor(np.asarray(h), dtype=torch.int64))
        if k + 1 in snaps:
            _, k_train, k_hp = jax.random.split(es.key, 3)
            d.train = [jax_train_draws(exp_j.model, es.params, snaps[k + 1].buf,
                                       jax.random.fold_in(k_train, 0), cfg.num_learning_opt,
                                       cfg.batch_size)]
            g = jax.random.uniform(jax.random.fold_in(k_hp, 0),
                                   (cfg.num_target_samples, cfg.s_dim),
                                   minval=exp_j.robot_lim[:, 0], maxval=exp_j.robot_lim[:, 1])
            d.grade_samples = [torch.tensor(np.asarray(g))]
        draws[k] = d
    return draws


def record(mode, make_bridge=None, fail_at=0):
    """The scenario on the JAX runner and on the port's, in ``mode``.
    ``make_bridge(bridge_module, env, state)`` builds each side's bridge
    (default the scripted bridge, rejecting the ``fail_at``-th command).
    Returns a dict of both sides' states, logs, saves, bridges and
    runners."""
    make_bridge = make_bridge or (
        lambda mod, env, state: scripted(mod.SyntheticBridge)(env, state, fail_at))
    exp_j, exp_t = experiments()
    es_j = exp_j.init(seed=0)
    bj = make_bridge(jb, exp_j.env, es_j.env)
    rj = JRunner(exp_j, bj, heartbeat=JBeat(period_s=100.0, timeout_s=0.0), **MODES[mode])
    snaps = {0: es_j}
    es_j, log_j, saves_j = drive(rj, es_j, bj,
                                 on_step=lambda es: snaps.setdefault(int(es.explr_step), es))

    es_t = exp_t.init(seed=0)
    es_t.model.load_state_dict(params_from_jax(snaps[0].params, es_t.model))
    es_t.env = arm_state_from_jax(snaps[0].env, "cpu")
    bt = make_bridge(tb, exp_t.env, es_t.env)
    rt = HostLoopRunner(exp_t, bt, heartbeat=RecoveryHeartbeat(period_s=100.0, timeout_s=0.0),
                        draws_fn=jax_draws(exp_j, snaps).get, **MODES[mode])
    es_t, log_t, saves_t = drive(rt, es_t, bt)
    return dict(jax=(es_j, log_j, saves_j, bj, rj), port=(es_t, log_t, saves_t, bt, rt))


def assert_step_matched(rec, cmds=True):
    es_j, log_j, saves_j, bj, rj = rec["jax"]
    es_t, log_t, saves_t, bt, rt = rec["port"]
    for k, (a, b) in enumerate(zip(log_t, log_j)):
        for key in ("events", "explr_step", "learning_ind", "paused", "pending", "obs",
                    "n_obs", "cmds"):
            assert a[key] == b[key], f"step {k} {key}: {a[key]} != {b[key]}"
        np.testing.assert_allclose(a["pose"], b["pose"], rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {k} pose")
    if cmds:
        assert len(bt.cmds) == len(bj.cmds)
        for k, (a, b) in enumerate(zip(bt.cmds, bj.cmds)):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4, err_msg=f"command {k}")
    assert saves_t == saves_j and rt.events == rj.events
    n = es_t.buf.size
    assert n == int(es_j.buf.size) and es_t.learning_ind == int(es_j.learning_ind)
    for name in ("x", "y", "force"):
        np.testing.assert_allclose(getattr(es_t.buf, name)[:n].float().numpy(),
                                   np.asarray(getattr(es_j.buf, name)[:n]), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(es_t.pstate.u.numpy(), np.asarray(es_j.pstate.u), rtol=2e-3,
                               atol=2e-4)


@pytest.fixture(scope="module")
def recordings():
    return {mode: record(mode, fail_at=9) for mode in ("serial", "host")}


@pytest.mark.parametrize("mode", ["serial", "host"])
def test_scenario_step_matched(recordings, mode):
    assert_step_matched(recordings[mode])


@pytest.mark.parametrize("mode", ["serial", "host"])
def test_forced_wedge_escapes_along_the_force(recordings, mode):
    """The stuck hits of the forced wedge command the escape along the
    contact force, +x out of the cylinder, before the absorb."""
    _, log, _, bridge, runner = recordings[mode]["port"]
    assert runner.events[:2] == ["stuck_escape", "stuck_escape"]
    escapes = [c for c in bridge.cmds if np.allclose(np.linalg.norm(c[:3]), 0.05)
               and np.allclose(c[3:], 0)]
    assert len(escapes) == 2 and all(c[0] > 0.04 for c in escapes)
    assert log[3]["explr_step"] == 4  # the experiment went on through it


@pytest.mark.parametrize("mode", ["serial", "host"])
def test_cmd_failure_pauses_then_heartbeat_recovers(recordings, mode):
    _, log, _, bridge, runner = recordings[mode]["port"]
    k = next(i for i, s in enumerate(log) if "cmd_failed" in s["events"])
    assert k == 7 and log[k]["paused"] and log[k]["pending"]  # the plan was dropped
    assert log[k]["explr_step"] == log[k - 1]["explr_step"]  # nothing absorbed
    assert not log[k + 2]["paused"] and log[k + 2]["events"].count("recover") == 2


@pytest.mark.parametrize("mode", ["serial", "host"])
def test_pause_blocks_motion_and_save_request_saves(recordings, mode):
    """The pause before step 5 holds the arm and the experiment; the
    heartbeat recovers at step 6. The save requested before step 7 waits
    out the failed command's pause and is served by the first step that
    absorbs again."""
    es, log, saves, bridge, runner = recordings[mode]["port"]
    assert log[5]["paused"] and log[5]["explr_step"] == log[4]["explr_step"]
    np.testing.assert_array_equal(log[5]["pose"], log[4]["pose"])
    assert log[5]["cmds"] == log[4]["cmds"]  # no command while paused
    assert log[6]["events"][-1] == "recover" and not log[6]["paused"]
    k = next(i for i, s in enumerate(log) if "save" in s["events"])
    assert k > 7 and saves == [log[k]["explr_step"]]


@pytest.mark.parametrize("mode", ["serial", "host"])
def test_one_observation_per_steady_step(recordings, mode):
    """A steady step pays one observation (the post-command frame is the
    next plan's); the first step and the step after a recovery re-sense
    first (two), and a stuck hit adds the post-escape frame."""
    log = recordings[mode]["port"][1]
    n = [log[0]["n_obs"]] + [b["n_obs"] - a["n_obs"] for a, b in zip(log, log[1:])]
    assert n[:5] == [2, 1, 2, 2, 1] and n[6] == 2 and n[10:] == [1, 1]
    assert (not log[1]["pending"]) is (mode == "host")


def test_pipeline_matches_serial_trajectory(recordings):
    """The host-pipelined step is a latency form of the serial one: the
    same poses, commands and samples."""
    s, h = recordings["serial"]["port"], recordings["host"]["port"]
    for a, b in zip(s[1], h[1]):
        np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-6)
        assert a["events"] == b["events"]
    for a, b in zip(s[3].cmds, h[3].cmds):
        np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(s[0].buf.x.numpy(), h[0].buf.x.numpy(), atol=1e-6)


def test_overridden_bridge_takes_the_host_path(recordings):
    """A bridge that overrides klerg_cmd or observe cannot use the
    device-resident step: both runners fall back to the host pipeline."""
    assert recordings["host"]["port"][4]._fast is recordings["host"]["jax"][4]._fast is False


def test_recover_drops_the_pipeline(recordings):
    runner = recordings["host"]["port"][4]
    runner._pending, runner._obs = object(), object()
    runner._recover()
    assert runner._pending is None and runner._obs is None and runner.events[-1] == "recover"


@pytest.mark.parametrize("reach", [True, False])
def test_goal_seek_matches_jax(reach):
    """drive_to_start on the arm: pose commands with retries, the reset at
    half the budget, yaw nudges; a bridge whose pose commands never move
    fails and logs it."""
    exp_j, exp_t = experiments()
    es_j = exp_j.init(seed=3)
    bj = jb.SyntheticBridge(exp_j.env, es_j.env)
    bt = tb.SyntheticBridge(exp_t.env, arm_state_from_jax(es_j.env, "cpu"))
    goal = np.array([0.5, 0.05, 0.35, 3.2, 0.0, 0.0])
    out = []
    for mod_runner, br in ((JRunner, bj), (HostLoopRunner, bt)):
        if not reach:
            br.klerg_pose = lambda pose6, brightness=-1.0: True
        runner = mod_runner(exp_j if br is bj else exp_t, br)
        runner.seeker.max_tries = 3
        ok, pos = runner.drive_to_start(goal, yaw_index=5)
        out.append((ok, pos, list(runner.events), runner._obs, runner._pending))
    (oj, pj, ej, *_), (ot, pt, et, obs, pending) = out
    assert oj == ot == reach and ej == et and obs is None and pending is None
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    if reach:
        assert np.linalg.norm(pt - goal) < 0.02
    else:
        assert et == ["recover", "goal_seek_failed"]  # the reset at half the budget


def test_panel_drives_runner_hooks():
    exp_j, exp_t = experiments()
    es = exp_t.init(seed=7)
    out = []
    for runner_cls, panel_cls, br in ((JRunner, JPanel, jb.SyntheticBridge(
            exp_j.env, exp_j.init(seed=7).env)), (HostLoopRunner, ControlPanel,
                                                  tb.SyntheticBridge(exp_t.env, es.env))):
        runner = runner_cls(exp_j if runner_cls is JRunner else exp_t, br)
        text = io.StringIO()
        panel = panel_cls(runner.hooks(), out=text)
        flags = []
        for line in ("pause", "resume", "mode pose", "save", "recover", "status"):
            panel.handle(line)
            flags.append((runner.pause.paused, runner.pause.save_requested))
        out.append((flags, text.getvalue(), list(runner.events)))
    assert out[0] == out[1]
    assert out[1][2] == ["recover"] and out[1][0][3] == (False, True)


def test_brightness_observed_back_from_node():
    class _Node:
        current = 0.37

    class _Bridge:
        brightness_node = _Node()
        pause = None

    exp_j, exp_t = experiments()
    assert HostLoopRunner(exp_t, _Bridge())._brightness(np.zeros(6)) == pytest.approx(0.37)
    assert JRunner(exp_j, _Bridge())._brightness(np.zeros(6)) == pytest.approx(0.37)


def test_config_fields_are_keyword_only():
    exp_j, exp_t = experiments()
    bt = tb.SyntheticBridge(exp_t.env, exp_t.init(seed=0).env)
    with pytest.raises(TypeError):
        HostLoopRunner(exp_t, bt, MetricsLog(None, echo=False))
    runner = HostLoopRunner(exp_t, bt, metrics=MetricsLog(None, echo=False))
    assert runner.pipeline is True and runner.draws_fn is None
    with pytest.raises(TypeError):
        JRunner(exp_j, bt, JMetrics(None, echo=False))

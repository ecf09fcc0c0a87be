"""The host loop's steps as captured steps (``HostLoopRunner.plan_graph``
for a plan from a host observation, ``step_graph`` for the absorb-and-plan
step or the serial step's absorb, ``runtime/graphs.py`` ``StepGraph``s)
and its plans on the runner's persistent fork, held on the CPU through
``EagerGraph``, whose replays call the step's body again on the static
buffers with the host values frozen at capture, as a CUDA graph does.

Each run drives the scenario of ``test_torch_host_loop.py`` (the
dynamic-contact arm in the wedge, a forced wedge, a pause the heartbeat
recovers, a save request; in the host-pipelined form a rejected command
too) with the experiment's own generators. The staged runner is held bit
for bit against the eager runner, step by step: every state leaf (the
generators' states included), the events, the counters, the pending
command and the bridge's pose. The host-pipelined runner's planner
generator and ring equal the serial runner's after every step, though the
pipelined runner has made one more plan, unused so far, and drops some
(the pause, the rejected command, the recovery): an unused plan leaves
the experiment's generator and ring as they were. The staged runner also
step-matches the JAX runner on the recorded scenarios of
``test_torch_host_loop.py`` and ``test_torch_host_loop_device.py``
(their tolerances). Last, the step graphs' base key holds the
generators: a re-initialised planner generator makes a fresh capture.
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

import test_torch_host_loop as thl
from ealv_tpu_torch.hw import bridge as tb
from ealv_tpu_torch.runtime import Experiment, HostLoopRunner
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime.checkpoint import state_leaves
from ealv_tpu_torch.runtime.watchdog import RecoveryHeartbeat
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_arm import big_cylinder
from test_torch_host_loop_device import custom
from test_torch_tick_graph import _experiment
from test_torch_trainer import one_torch_thread  # noqa: F401

# the composed device-resident step, the device-resident step with the
# bridge's own cmd_observe_device, the host-pipelined step (a bridge that
# records its commands and rejects the ninth), the serial step
FORMS = {"device": (dict(pipeline=True), lambda env, s: tb.SyntheticBridge(env, s)),
         "custom": (dict(pipeline=True), lambda env, s: custom(tb)(env, s)),
         "host": (dict(pipeline=True, device_fast=False),
                  lambda env, s: thl.scripted(tb.SyntheticBridge)(env, s, 9)),
         "serial": (dict(pipeline=False),
                    lambda env, s: thl.scripted(tb.SyntheticBridge)(env, s, 9))}


def _leaves(es):
    return [(p, v.clone() if isinstance(v, torch.Tensor) else v) for p, v in state_leaves(es)]


def _planner_parts(es):
    """The experiment's planner generator state and ring, copied."""
    m = es.pstate.memory
    return (es.pstate.gen.get_state(),
            *(getattr(m, f.name).clone() for f in dataclasses.fields(m)))


def _fed_draws(cfg, n, seed=3):
    """Fed draws for the first ``n`` explored steps of a toy run whose
    rings do not wrap: history and batch indices among the filled slots,
    samples in the robot limits."""
    from ealv_tpu_torch.runtime import TickDraws, TrainDraws
    rng = np.random.default_rng(seed)
    lim, cap = cfg.robot_lim, cfg.traj_buffer_capacity
    out = {}
    for k in range(n):
        hist = np.concatenate([rng.permutation(k + 1), k + 1 + rng.permutation(cap - k - 1)])
        shape = (cfg.num_learning_opt, cfg.batch_size)
        out[k] = TickDraws(
            samples=torch.tensor(rng.uniform(lim[:, 0], lim[:, 1], (cfg.num_target_samples,
                                                                    cfg.s_dim)),
                                 dtype=torch.float32),
            hist_idx=torch.tensor(hist[: cfg.num_traj_samples]),
            train=[TrainDraws(idx=torch.tensor(rng.integers(0, k + 1, shape)),
                              idx2=torch.tensor(rng.integers(0, k + 1, shape)),
                              eps=torch.tensor(rng.standard_normal((*shape, cfg.z_dim)),
                                               dtype=torch.float32))])
    return out


def _run(form, staged, n_steps=thl.N_STEPS, fed=False):
    """The scenario through ``form`` on a port experiment from seed 0 (its
    own generators), staged through ``StepGraph(EagerGraph)`` or eager.
    Per step: the runner's log (``thl.drive``), every state leaf, the
    planner generator and ring, the pending command, the fork's generator.
    Returns (runner, bridge, log, leaves, planner parts, pending commands,
    fork generator states)."""
    kw, make_bridge = FORMS[form]
    _, ts = big_cylinder()
    exp = Experiment(ExperimentConfig(**thl.TINY), train_calls_per_tick=1, scene=ts,
                     device="cpu")
    es = exp.init(seed=0)
    bridge = make_bridge(exp.env, es.env)
    runner = HostLoopRunner(exp, bridge, heartbeat=RecoveryHeartbeat(period_s=100.0,
                                                                     timeout_s=0.0),
                            draws_fn=_fed_draws(exp.cfg, n_steps + 1).get if fed else None,
                            **kw)
    assert runner.step_graph is None and runner.plan_graph is None  # no graphs on the CPU
    if staged:
        runner.step_graph = tg.StepGraph(tg.EagerGraph)
        runner.plan_graph = tg.StepGraph(tg.EagerGraph)
    leaves, parts, cmds, forks = [], [], [], []

    def on_step(es):
        leaves.append(_leaves(es))
        parts.append(_planner_parts(es))
        cmds.append(None if runner._pending is None else runner._pending[2].clone())
        forks.append(runner._fork_generator.get_state())

    es, log, saves = thl.drive(runner, es, bridge, on_step=on_step, n_steps=n_steps)
    return runner, bridge, log, leaves, parts, cmds, forks


def _equal(a, b, what):
    for (pa, x), (pb, y) in zip(a, b, strict=True):
        assert pa == pb
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {pa}"
        else:
            assert x == y, f"{what}: {pa}"


@pytest.mark.parametrize("form", ["device", "custom", "host", "serial"])
def test_staged_host_loop_equals_the_eager_runner(form):
    """Twelve steps with stuck hits, a pause, a recovery and a save (and a
    rejected command in the host-pipelined and serial forms): the staged
    runner's every state leaf, event, counter, pending command and pose
    equal the eager runner's after every step. The steady steps replay
    their pattern's graph; a stuck hit, the pause and the recovery prime a
    plan through the plan graph, through which the serial runner makes
    every plan."""
    eager, staged = _run(form, False), _run(form, True)
    for k, (a, b) in enumerate(zip(eager[2], staged[2], strict=True)):
        assert {**a, "pose": None} == {**b, "pose": None}, k
        np.testing.assert_array_equal(a["pose"], b["pose"])
        _equal(eager[3][k], staged[3][k], f"step {k}")
        assert (eager[5][k] is None) == (staged[5][k] is None), k
        if eager[5][k] is not None:
            assert torch.equal(eager[5][k], staged[5][k]), k
    assert eager[0].events == staged[0].events and "recover" in staged[0].events
    g = staged[0].step_graph
    assert g.replays >= 2 and g.captures >= 1, g.counts
    if form == "serial":
        p = staged[0].plan_graph
        assert p.replays >= 2 and p.captures >= 1, p.counts
    if form in ("host", "serial"):
        assert [c.tolist() for c in eager[1].cmds] == [c.tolist() for c in staged[1].cmds]
        assert "cmd_failed" in staged[0].events


@pytest.mark.parametrize("staged", [False, True], ids=["eager", "staged"])
def test_unused_plans_leave_the_planner_generator_and_ring(staged):
    """The host-pipelined runner plans each next step after its absorb, on
    the fork, and drops that plan at the pause, the rejected command and
    the recovery; the serial runner makes only the plans it uses. After
    every step the two experiments' planner generators (their own draws)
    and rings are equal, and the pipelined runner's fork has moved on."""
    piped, serial = _run("host", staged), _run("serial", False)
    for k, (a, b) in enumerate(zip(piped[4], serial[4], strict=True)):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"step {k}"
    assert piped[2][-1]["explr_step"] == serial[2][-1]["explr_step"]
    events = piped[0].events
    assert "cmd_failed" in events and "recover" in events and "stuck_escape" in events
    fork = piped[0]._fork_generator.get_state()
    assert not torch.equal(fork, piped[4][-1][0])  # the last, pending plan drew on the fork


@pytest.mark.parametrize("form", ["host", "device"])
def test_every_runner_takes_the_fed_draws(form):
    """Fed draws reach every plan and every absorb in the serial runner as
    in the pipelined ones (staged): given the same draws and the same
    observations, their trainer and planner states after the scenario are
    bit-equal, generators included (no draw came from them)."""
    serial, other = _run("serial", False, fed=True), _run(form, True, fed=True)
    assert serial[2][-1]["learning_ind"] > 0
    k = len(serial[3]) - 1
    if form == "device":  # its watchdog acts a step later: up to the first stuck hit
        k = next(i for i, s in enumerate(serial[2]) if s["events"]) - 1
    _equal(serial[3][k], other[3][k], f"step {k}")


def test_device_step_drops_plans_outside_the_experiment():
    """The device-resident runner, staged: the pause drops the plan made
    in the step before it (the experiment's planner generator and ring
    stay as that step left them, while the fork's generator has drawn for
    it), and so does the deferred watchdog's stuck hit; each absorbed step
    pushes one row to the experiment's ring, so no unused plan pushed
    there."""
    runner, bridge, log, leaves, parts, cmds, forks = _run("device", True)
    assert log[5]["paused"] and log[4]["explr_step"] == log[5]["explr_step"]
    assert all(torch.equal(x, y) for x, y in zip(parts[4], parts[5]))
    assert not torch.equal(forks[4], parts[4][0])
    size0 = int(parts[0][3]) - log[0]["explr_step"]
    assert [int(p[3]) - size0 for p in parts] == [s["explr_step"] for s in log]
    # ("pending" logs that none is held) the stuck hit of step 2 drops the
    # plan that step made, step 3 primes one
    assert log[2]["pending"] and not log[3]["pending"]
    assert not torch.equal(forks[2], parts[2][0]) and "stuck_escape" in runner.events


@contextlib.contextmanager
def _staged_runners():
    """``test_torch_host_loop.record`` with the port's runner staged."""

    class Staged(HostLoopRunner):
        def __post_init__(self):
            super().__post_init__()
            self.step_graph = tg.StepGraph(tg.EagerGraph)
            self.plan_graph = tg.StepGraph(tg.EagerGraph)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thl, "HostLoopRunner", Staged)
        yield


@pytest.fixture(scope="module")
def staged_recordings():
    with _staged_runners():
        return {"host": thl.record("host", fail_at=9),
                "device": thl.record("device",
                                     lambda mod, env, state: mod.SyntheticBridge(env, state)),
                "custom": thl.record("device", lambda mod, env, state: custom(mod)(env, state))}


@pytest.mark.parametrize("form", ["host", "device", "custom"])
def test_staged_runner_matches_jax(staged_recordings, form):
    """The JAX scenarios (fed the JAX draws) through the staged runner in
    the host-pipelined and both device-resident forms: step-matched as the
    eager runner is, and the steady steps replayed their graphs."""
    rec = staged_recordings[form]
    runner = rec["port"][4]
    assert runner.step_graph.replays >= 2, runner.step_graph.counts
    thl.assert_step_matched(rec, cmds=form == "host")


def test_a_new_planner_generator_makes_a_fresh_capture():
    """The tick graph's base key holds the generators themselves: after the
    planner's generator is replaced by a new one (as a second run does),
    the next tick of a captured pattern runs eagerly and captures again,
    drawing from the new generator, and equals the eager experiment's
    tick with the same replacement; the old generator is held by the key,
    so no new generator can take its identity."""
    exps = [_experiment(staged) for staged in (False, True)]
    runs = [(exp, exp.init(seed=0)) for exp in exps]
    for exp, es in runs:
        for _ in range(3):
            exp.tick(es)
    g = exps[1].tick_graph
    assert (g.warmups, g.captures, g.replays) == (1, 1, 2)  # one pattern
    old = runs[1][1].pstate.gen
    for _, es in runs:
        es.pstate = dataclasses.replace(es.pstate, gen=torch.Generator().manual_seed(11))
    gc.collect()
    assert any(x is old for x in g.base[0])
    infos = [[exp.tick(es)[1]] for exp, es in runs]
    assert (g.warmups, g.captures, g.replays) == (2, 1, 2)  # eager: no stale replay
    for (exp, es), out in zip(runs, infos):
        out += [exp.tick(es)[1] for _ in range(2)]
    assert g.captures == 2  # the pattern captured again
    for a, b in zip(*infos):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    _equal(_leaves(runs[0][1]), _leaves(runs[1][1]), "after the new generator")

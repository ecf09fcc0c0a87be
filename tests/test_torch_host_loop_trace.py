"""The host loop under the tracer (``runtime/tracing.py``) and with no
trainer call: the scenario of ``test_torch_host_loop.py`` (the
dynamic-contact arm in the wedge, a forced wedge, a pause the heartbeat
recovers, a save; in the host-pipelined and serial forms a rejected
command too) through the serial, host-pipelined and device-resident
runners, staged through ``StepGraph(EagerGraph)`` on the CPU, where a
stamp takes the host clock.

Each step is one tick: its device stamps open and close in nested pairs,
and its spans nest under the host and device ``tick``; the counters
``prime``, ``stuck``, ``escape``, ``recover`` and ``drift`` equal the
runner's plans from host observations, its events and the arm's drift
corrections; off, the tracer builds, stamps and counts nothing, and on it
changes no state. ``Experiment(train_calls_per_tick=0)`` runs through every
form, eagerly and staged, bit-equal, its model and optimizer untouched.
"""

import dataclasses

import pytest
import torch

import test_torch_host_loop as thl
from ealv_tpu_torch.runtime import Experiment, HostLoopRunner, tracing
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime.watchdog import RecoveryHeartbeat
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_arm import big_cylinder
from test_torch_host_loop_graph import FORMS, _equal, _leaves
from test_torch_trainer import one_torch_thread  # noqa: F401

DRIFT_EVERY = 3  # a drift correction every third command, so the scenario makes several
RUNNER_FORMS = ["serial", "host", "device"]


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    yield
    tracing.disable()


def _run(form, staged, calls=1):
    """The scenario through ``form`` from seed 0 with ``calls`` trainer
    calls a step. Returns (runner, bridge, final state, log)."""
    kw, make_bridge = FORMS[form]
    _, ts = big_cylinder()
    exp = Experiment(ExperimentConfig(**thl.TINY), train_calls_per_tick=calls, scene=ts,
                     device="cpu")
    exp.env = dataclasses.replace(exp.env, drift_every=DRIFT_EVERY)
    es = exp.init(seed=0)
    bridge = make_bridge(exp.env, es.env)
    runner = HostLoopRunner(exp, bridge, heartbeat=RecoveryHeartbeat(period_s=100.0,
                                                                     timeout_s=0.0), **kw)
    if staged:
        runner.step_graph = tg.StepGraph(tg.EagerGraph)
        runner.plan_graph = tg.StepGraph(tg.EagerGraph)
    es, log, _ = thl.drive(runner, es, bridge)
    return runner, bridge, es, log


def _descends(spans, i, top) -> bool:
    while spans[i].parent is not None:
        i = spans[i].parent
    return i == top


@pytest.mark.parametrize("calls", [0, 1], ids=["untrained", "trained"])
@pytest.mark.parametrize("form", RUNNER_FORMS)
def test_each_step_balances_and_nests_its_spans(form, calls, monkeypatch):
    """Every step's device stamps open and close in nested pairs of one
    name (``env``, opened at the plan's command, closes with the command's
    conversion); each step has one host and one device ``tick``, every
    other span of the step under them; a step that absorbed has an
    ``absorb`` span, and in the device-resident form an ``arm``; every
    step that checked a watchdog slice has a host ``watchdog`` span."""
    stamps = []
    real = tracing._Tracer.stamp

    def recorded(self, name, edge):
        stamps.append((self.current, name, edge))
        real(self, name, edge)

    monkeypatch.setattr(tracing._Tracer, "stamp", recorded)
    tracing.enable("cpu")
    runner, _, _, log = _run(form, True, calls)
    tr = tracing.read()
    n = len(log)
    assert tr.ticks == range(n) and all(t is not None for t, _, _ in stamps)
    for t in range(n):
        open_ = []
        for tick, name, edge in stamps:
            if tick != t:
                continue
            if edge == 0:
                open_.append(name)
            else:
                assert open_ and open_.pop() == name, (t, name)
        assert not open_, (t, open_)
    absorbed = [log[0]["explr_step"] > 0] + [b["explr_step"] > a["explr_step"]
                                            for a, b in zip(log, log[1:])]
    for kind, spans in (("host", tr.host), ("device", tr.device)):
        for t in range(n):
            mine = [i for i, s in enumerate(spans) if s.tick == t]
            (top,) = [i for i in mine if spans[i].name == "tick"]
            assert spans[top].parent is None
            assert all(_descends(spans, i, top) for i in mine), (kind, t)
            names = {spans[i].name for i in mine}
            if kind == "device":
                assert ("absorb" in names) == absorbed[t], (t, names)
                assert ("arm" in names) == (absorbed[t] and form == "device"), (t, names)
    watchdog = {s.tick for s in tr.host if s.name == "watchdog"}
    if form == "device":  # the deferred check: from the second absorbed step on, and
        # run()'s check of the last held slice, outside every step
        assert None in watchdog and min(t for t in watchdog if t is not None) >= 1
    else:
        assert watchdog == {t for t in range(n) if absorbed[t]}
    assert min(tracing.self_ns(tr.device)) >= 0 and min(tracing.self_ns(tr.host)) >= 0


@pytest.mark.parametrize("form", RUNNER_FORMS)
def test_counters_equal_the_events_and_the_drift(form):
    """The summary's counters: ``prime`` the plans made from a host
    observation (every one through the plan graph), ``stuck`` the stuck
    hits, ``escape`` the escapes, ``recover`` the recoveries, ``drift`` the
    arm's drift corrections (one every ``DRIFT_EVERY`` commands, escapes
    included)."""
    tracing.enable("cpu")
    runner, bridge, _, _ = _run(form, True)
    counts = tracing.summary(tracing.read())["counts"]
    ev = runner.events
    plan = runner.plan_graph.counts
    assert counts.get("prime", 0) == sum(c[0] + c[2] for c in plan.values()) > 0
    assert counts.get("stuck", 0) == ev.count("stuck_escape") + ev.count("stuck_reset") > 0
    assert counts.get("escape", 0) == ev.count("stuck_escape") > 0
    assert counts.get("recover", 0) == ev.count("recover") > 0
    assert counts.get("drift", 0) == bridge.state.count // DRIFT_EVERY > 0


def test_count_is_free_and_absent_off(monkeypatch):
    """Off, the runner's steps build no tracer and call none of its
    methods, counters included; on, every state leaf after the scenario is
    bit-equal to that of the run with it off."""
    def called(*a, **k):
        raise AssertionError("the tracer ran while off")

    with monkeypatch.context() as m:
        for name in ("__init__", "stamp", "span", "tick", "count", "read"):
            m.setattr(tracing._Tracer, name, called)
        off = _run("device", True)
    assert tracing.state() is None
    tracing.enable("cpu")
    on = _run("device", True)
    assert on[0].events == off[0].events
    _equal(_leaves(off[2]), _leaves(on[2]), "tracer on")
    assert tracing.summary(tracing.read())["counts"]["drift"] > 0


@pytest.mark.parametrize("form", RUNNER_FORMS)
def test_no_trainer_call_runs_through_the_runner(form):
    """``Experiment(train_calls_per_tick=0)``: the scenario runs eagerly and
    staged, bit-equal step for step, with no trainer call; the model keeps
    its initial weights and the optimizer holds no state; the staged steps
    replay their graphs."""
    eager, staged = _run(form, False, calls=0), _run(form, True, calls=0)
    for a, b in zip(eager[3], staged[3], strict=True):
        assert {**a, "pose": None} == {**b, "pose": None}
    _equal(_leaves(eager[2]), _leaves(staged[2]), "staged")
    init = Experiment(ExperimentConfig(**thl.TINY), train_calls_per_tick=0,
                      device="cpu").init(seed=0)
    for es in (eager[2], staged[2]):
        assert es.learning_ind == 0 and es.explr_step > 0 and not es.opt.state
        for (n, p), q in zip(es.model.named_parameters(), init.model.parameters()):
            assert torch.equal(p, q), n
    assert staged[0].step_graph.replays >= 2

"""The tracer (``runtime/tracing.py``): host spans around the tick's calls
and device stamps at its layer boundaries, held on the CPU through
``EagerGraph`` at toy size, where a stamp takes the host clock; and, on the
card, the stamp kernel in a captured step.

This file imports neither JAX nor the JAX package, so its CUDA case runs
on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import numpy as np
import pytest
import torch

from ealv_tpu_torch.control import ExplrDist
from ealv_tpu_torch.runtime import EvalExperiment, Experiment
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime import tracing
from ealv_tpu_torch.utils.config import ExperimentConfig

TOY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
           cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=64,
           num_traj_samples=50, traj_buffer_capacity=128, buffer_capacity=128,
           batch_size=8, num_learning_opt=2)
TICKS = 10  # three tick patterns (a trainer call every third tick) warm, capture and replay
HOST_CHILDREN = {"key", "stage", "replay", "clone"}


@pytest.fixture(autouse=True)
def tracer_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()
    torch.set_num_threads(threads)


class Runtime:
    """A toy learning (``Experiment``) or eval (``EvalExperiment``) runtime
    on the CPU, its ticks through ``StepGraph``s over ``graph_type``."""

    def __init__(self, kind: str, graph_type=tg.EagerGraph):
        self.kind = kind
        cfg = ExperimentConfig(**TOY)
        if kind == "learn":
            self.exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, device="cpu")
            self.state = self.exp.init(seed=0)
        else:
            self.exp = EvalExperiment(cfg, pdf_fn=lambda ctx, s: ctx.pdf(s), device="cpu")
            self.state = self.exp.init(seed=0)
            rng = np.random.default_rng(3)
            self.ctx = ExplrDist.create(8, 3, device="cpu")
            t = lambda a: torch.tensor(a, dtype=torch.float32)
            for _ in range(3):
                self.ctx = self.ctx.push(t(rng.uniform(-0.6, 0.6, 3)),
                                         t(rng.uniform(0.02, 0.08, 3)))
        self.exp.tick_graph = tg.StepGraph(graph_type)
        self.trained = []  # whether each tick made a trainer call

    def tick(self) -> dict:
        if self.kind == "learn":
            before = self.state.learning_ind
            _, info = self.exp.tick(self.state)
            self.trained.append(self.state.learning_ind > before)
        else:
            self.state, info = self.exp.tick(self.state, self.ctx)
            self.trained.append(False)
        return {k: v.clone() for k, v in info.items()}


@pytest.mark.parametrize("kind", ["learn", "eval"])
def test_off_the_tracer_runs_nothing_and_on_it_changes_no_output(kind, monkeypatch):
    """With the tracer off no stamp, span or tick of the tracer runs; with it
    on, every tick's outputs are bit-equal to those with it off."""
    def called(*a, **k):
        raise AssertionError("the tracer ran while off")

    with monkeypatch.context() as m:
        for name in ("stamp", "span", "tick", "count", "read"):
            m.setattr(tracing._Tracer, name, called)
        off = Runtime(kind)
        infos_off = [off.tick() for _ in range(TICKS)]
    tracing.enable("cpu")
    on = Runtime(kind)
    infos_on = [on.tick() for _ in range(TICKS)]
    assert len(tracing.read().device) > 0
    if kind == "learn":
        assert any(off.trained) and off.trained == on.trained
    for a, b in zip(infos_off, infos_on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind", ["learn", "eval"])
def test_each_tick_nests_its_host_and_device_spans(kind):
    """Each tick: a host ``tick`` span over ``key``, ``stage``, ``replay``
    and ``clone`` (once its pattern replays), and the device span ``tick``
    over ``decode``, ``descent``, ``env`` (and ``absorb``, with one
    ``train`` inside it for each trainer call), in that order, all under one
    tick id; no self time is negative."""
    tracing.enable("cpu")
    rt = Runtime(kind)
    for _ in range(TICKS):
        rt.tick()
    tr = tracing.read()
    assert tr.ticks == range(TICKS) and tr.lost == 0 and tr.offset_ns == 0
    assert min(tracing.self_ns(tr.host)) >= 0 and min(tracing.self_ns(tr.device)) >= 0
    layers = ["decode", "descent", "env"] + (["absorb"] if kind == "learn" else [])
    replayed = 0
    for t in range(TICKS):
        host = [(i, s) for i, s in enumerate(tr.host) if s.tick == t]
        (top, tick), = [(i, s) for i, s in host if s.name == "tick"]
        assert tick.parent is None
        children = {s.name for i, s in host if i != top}
        assert all(s.parent == top for i, s in host if i != top)
        assert "key" in children and children <= HOST_CHILDREN
        replayed += children == HOST_CHILDREN

        device = [(i, s) for i, s in enumerate(tr.device) if s.tick == t]
        (dtop, dtick), = [(i, s) for i, s in device if s.name == "tick"]
        assert dtick.parent is None and tick.start_ns <= dtick.start_ns <= dtick.end_ns \
            <= tick.end_ns
        under = [s for i, s in device if s.parent == dtop]
        assert [s.name for s in under] == layers
        assert all(a.end_ns <= b.start_ns for a, b in zip(under, under[1:]))
        train = [s for i, s in device if s.name == "train"]
        assert len(train) == rt.trained[t]
        if train:
            absorb = next(i for i, s in device if s.name == "absorb")
            assert train[0].parent == absorb
    assert replayed >= 3
    assert sum(rt.trained) >= (2 if kind == "learn" else 0)


class RecordingGraph(tg.EagerGraph):
    """An ``EagerGraph`` that notes the tracer's state at its capture and
    every replay."""

    seen: list = []

    def capture(self, body, static):
        super().capture(body, static)
        self.state = tracing.state()

    def replay(self):
        RecordingGraph.seen.append((self.state, tracing.state()))
        return super().replay()


@pytest.mark.parametrize("kind", ["learn", "eval"], ids=["step", "eval"])
def test_toggling_the_tracer_drops_the_graphs(kind):
    """Turning the tracer on or off drops every step graph (the learning
    tick's, the eval tick's): the next tick runs eagerly and captures anew,
    and no graph replays in a state other than its capture's."""
    RecordingGraph.seen = []
    rt = Runtime(kind, RecordingGraph)
    counts = lambda: [(g.warmups, g.captures) for g in (rt.exp.tick_graph,)]
    for toggle in (None, lambda: tracing.enable("cpu"), tracing.disable,
                   lambda: tracing.enable("cpu")):
        if toggle is not None:
            toggle()
        before = counts()
        for _ in range(TICKS):
            rt.tick()
        after = counts()
        for (w0, c0), (w1, c1) in zip(before, after):
            assert w1 > w0 and c1 > c0
    assert len({s for s, _ in RecordingGraph.seen}) == 3  # off, then two enables
    assert all(captured == now for captured, now in RecordingGraph.seen)


def test_read_selects_a_window_by_tick_ids():
    """``read(first, last)`` gives the spans of ticks ``first`` to ``last``
    and drains everything before; a later ``read()`` starts there."""
    tracing.enable("cpu")
    rt = Runtime("eval")
    for _ in range(6):
        rt.tick()
    assert tracing.ticks() == 6
    tr = tracing.read(2, 4)
    assert tr.ticks == range(2, 4)
    assert {s.tick for s in tr.host} == {2, 3} == {s.tick for s in tr.device}
    assert [s.name for s in tr.device].count("tick") == 2
    assert all(s.parent is None or tr.host[s.parent].tick == s.tick for s in tr.host)
    for _ in range(2):
        rt.tick()
    later = tracing.read()
    assert later.ticks == range(6, 8)
    assert {s.tick for s in later.host} == {6, 7} == {s.tick for s in later.device}


def test_stamps_outside_a_tick_do_nothing():
    tracing.enable("cpu")
    tracing.begin("decode")
    tracing.end("decode")
    with tracing.tick():
        tracing.begin("x")
        tracing.end("x")
    tr = tracing.read()
    assert [s.name for s in tr.device] == ["x"] and tr.device[0].tick == 0


def test_a_capture_ahead_counts_no_tick_and_opens_no_span():
    """``ahead()``, around a step captured ahead of the tick that first
    replays it: its stamps are taken (on the card a graph records them),
    no tick is counted and no host span opened; the next tick's first
    stamp clears its row as ever. Inside a tick it raises."""
    tracing.enable("cpu")
    with tracing.tick():
        tracing.begin("x")
        tracing.end("x")
    with tracing.ahead():
        tracing.begin("y")
        tracing.end("y")
    assert tracing.ticks() == 1
    with tracing.tick():
        with pytest.raises(RuntimeError, match="inside a tick"):
            with tracing.ahead():
                pass
        tracing.begin("x")
        tracing.end("x")
    tr = tracing.read()
    assert [(s.name, s.tick) for s in tr.device] == [("x", 0), ("x", 1)]
    assert [(s.name, s.tick) for s in tr.host] == [("tick", 0), ("tick", 1)]


def test_counts_are_kept_per_tick_and_summed():
    """``count`` adds to the open tick's counter (outside every tick, to
    the run's); ``read`` keeps a window's ticks' counts, or all of them
    with those outside, and drains them; ``summary`` sums each over the
    trace and ``describe`` lists the sums. Off, ``count`` does nothing."""
    tracing.count("prime")  # off: nothing is kept, nothing raises
    tracing.enable("cpu")
    tracing.count("stuck")  # outside every tick
    for t in range(4):
        with tracing.tick():
            tracing.count("prime")
            if t % 2:
                tracing.count("drift", 3)
    tr = tracing.read(1, 3)
    assert tr.counts == {"prime": {1: 1, 2: 1}, "drift": {1: 3}}
    s = tracing.summary(tr)
    assert s["counts"] == {"prime": 2, "drift": 3}
    assert "tracer: counts: drift 3, prime 2" in tracing.describe(s)
    with tracing.tick():
        tracing.count("escape")
    assert tracing.read().counts == {"escape": {4: 1}}  # the earlier ones were drained
    tracing.count("recover")
    assert tracing.summary(tracing.read())["counts"] == {"recover": 1}
    tracing.disable()
    tracing.count("prime")
    assert tracing.state() is None


def test_summary_puts_each_gap_down_to_a_host_span():
    """The summary's arithmetic on two synthetic ticks: self times, the
    window's share with no device tick open, each gap under the innermost
    host span over its midpoint."""
    S = tracing.Span
    host = [S("tick", 0, None, 0, 100), S("replay", 0, 0, 10, 90),
            S("tick", 1, None, 150, 250), S("key", 1, 2, 150, 170)]
    device = [S("tick", 0, None, 20, 120), S("decode", 0, 0, 30, 60),
              S("tick", 1, None, 180, 240), S("train", 1, 2, 190, 230)]
    tr = tracing.Trace(ticks=range(2), host=host, device=device, offset_ns=0,
                       uncertainty_ns=0, drift_ns=0, lost=0)
    assert tracing.self_ns(host) == [20, 80, 80, 20]
    assert tracing.self_ns(device) == [70, 30, 20, 40]
    s = tracing.summary(tr)
    # the window 0-250: device ticks cover 20-120 and 180-240
    assert s["device_wait_pct"] == pytest.approx(90 / 250 * 100)
    # gaps 0-20 (mid 10: replay), 120-180 (mid 150: key), 240-250 (mid 245: tick)
    assert s["wait_ms"] == pytest.approx({"replay": 10e-6, "key": 30e-6, "tick": 5e-6})
    assert s["device_ms"]["train"] == pytest.approx(20e-6)
    assert s["device_calls"] == {"tick": 2, "decode": 1, "train": 1}
    assert s["host_self_ms"] == pytest.approx({"tick": 50e-6, "replay": 40e-6, "key": 10e-6})
    outside = tracing.summary(tr, lo=-100, hi=250)
    assert outside["wait_ms"]["outside"] == pytest.approx(60e-6)  # -100 to 20, over 2 ticks
    assert "device wait 36.00%" in tracing.describe(s)


def test_run_entry_profile_logs_the_split(tmp_path):
    """``run_experiment --profile`` at ``--small`` on the CPU, 6 steps in
    chunks of 2: the program's spans in the Chrome trace of the second
    chunk, the split of the third in ``log.txt``, the tracer off after."""
    import json
    import os
    from ealv_tpu_torch.scripts import run_experiment as cli
    out = str(tmp_path / "run")
    cli.main(["--small", "--device", "cpu", "--chunk", "2", "--steps", "6", "--no-post-train",
              "--profile", "--out", out])
    d = os.path.join(out, "synth", "entklerg_0000")
    with open(os.path.join(d, "profile", "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert "ealv.tick" in names
    log = open(os.path.join(d, "log.txt")).read()
    assert "tracer: 2 ticks; host self ms a tick: tick " in log
    assert "tracer: device ms a tick: tick " in log and "decode" in log
    assert "tracer: device wait " in log and tracing.state() is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_stamps_write_consecutive_rows(cuda):
    """On the card a captured step's stamps land, replay after replay, in
    the ring's consecutive rows with rising times, mapped onto the host
    clock inside each tick's host span."""
    tracing.enable(cuda)
    graph = tg.StepGraph()

    def body(carry, draws):
        tracing.begin("tick")
        tracing.begin("work")
        new = carry * 2.0 + 1.0
        tracing.end("work")
        tracing.end("tick")
        return new, new.sum()

    carry = torch.zeros(4, device=cuda)
    for _ in range(6):
        with tracing.tick():
            carry, _ = graph.step(lambda: (), (), carry, None, body, [])
    torch.cuda.synchronize()
    assert graph.warmups == 1 and graph.captures == 1 and graph.replays == 5
    rows = tracing._tracer.ring[:6].cpu()
    assert (rows[:, :4] > 0).all()  # tick and work, begin and end, in every row
    assert (rows[1:, 0] > rows[:-1, 0]).all()
    tr = tracing.read()
    assert tr.uncertainty_ns < 1_000_000
    by_tick = {t: [s for s in tr.device if s.tick == t] for t in range(6)}
    host = {s.tick: s for s in tr.host if s.name == "tick"}
    for t, spans in by_tick.items():
        assert [s.name for s in spans] == ["tick", "work"]
        assert spans[1].parent is not None
        # the stamps run on the card after the host launched them
        assert spans[0].start_ns >= host[t].start_ns - tr.uncertainty_ns
    starts = [by_tick[t][0].start_ns for t in range(6)]
    assert starts == sorted(starts)

"""No host round trip on the tick, checked on the CPU: every operation
that would make the host wait for the card if its tensors lay there is
counted while the tick's calls run at toy size. On a CUDA tensor these
synchronise: a tensor built from Python data (``torch.tensor``, a Python
list as an index, a Python scalar written into one element) is a blocking
copy from pageable host memory; ``.item()``, ``bool(tensor)`` and the like
read a value back; ``nonzero`` and boolean-mask indexing size their output
from the data. The card runs the same calls under
``torch.cuda.set_sync_debug_mode("error")`` (``chip_smoke.py`` at the
production size and ``tests/test_torch_cuda.py`` at toy size, both with
the ticks built here: this file imports no JAX, so it loads on the card's
machine).
"""

import collections
import dataclasses
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ealv_tpu_torch.fingerprint import FingerprintSet
from ealv_tpu_torch.fingerprint.capture import capture_fingerprint, capture_start, \
    capture_step, make_capture_target
from ealv_tpu_torch.fingerprint.test_runtime import (FingerprintMatrixRuntime,
                                                     _identification_tick)
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.runtime import EvalExperiment, Experiment
from ealv_tpu_torch.sim import SyntheticEnv, TrayScene
from ealv_tpu_torch.utils.config import TRAY_LIM, ExperimentConfig

TRAY6 = tuple(TRAY_LIM[s] for s in "xyzrpw")
TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2)
# the fingerprint stage's toy widths (chip_smoke.py's FP_TOY)
FP_TOY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
              cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
              num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
              compute_dtype="float32")
FP_COMBOS = (("L2", False), ("KL", False), ("BC", False), ("L2", True))
ROUND_TRIPS = {"aten.lift_fresh.default": "a tensor from Python data",
               "aten._local_scalar_dense.default": "a value read back",
               "aten.nonzero.default": "nonzero", "aten.masked_select.default": "masked_select"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """``test_torch_trainer.one_torch_thread``, which this file cannot
    import without JAX: torch on one thread beside the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RoundTrips(TorchDispatchMode):
    """Counts the operations of ``ROUND_TRIPS`` and boolean-mask indexing,
    each with the port's line that made it."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()

    def _where(self):
        frames = [f for f in traceback.extract_stack() if "ealv_tpu_torch" in f.filename]
        return f"{frames[-1].filename.split('ealv_tpu_torch')[-1]}:{frames[-1].lineno}" \
            if frames else "?"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        what = ROUND_TRIPS.get(str(func))
        if str(func) == "aten.index.Tensor" and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            what = "boolean-mask index"
        if what:
            self.found[(what, self._where())] += 1
        return func(*args, **(kwargs or {}))


def _round_trips(parts):
    """Run the calls ``parts`` [(name, call)] in order; every round trip
    they made, as {name: Counter}."""
    out = {}
    for name, call in parts:
        mode = RoundTrips()
        with mode:
            call()
        if mode.found:
            out[name] = mode.found
    return out


def test_step_vel_builds_no_tensor_from_python_data():
    """The limits and the z-mask are built once, not at every step: a
    step's only tensors come from the state and the command."""
    env = SyntheticEnv(tray_lim=TRAY6, img_hw=(16, 16), device="cpu")
    s = env.init(torch.tensor([0.42, -0.06, 0.21, 0.0, 0.0, 0.0]))
    cmd = torch.tensor([0.02, -0.01, -0.05, 0.0, 0.0, 0.1])
    target = torch.tensor([0.5, 0.05, 0.32, 3.1, 0.0, 0.2])
    env.step_vel(s, cmd)  # the constants' first use builds them
    assert _round_trips([("step_vel", lambda: env.step_vel(s, cmd)),
                         ("step_pose", lambda: env.step_pose(s, target)),
                         ("observe", lambda: env.observe(s))]) == {}


def untrained_tick(exp, es):
    """``Experiment.tick`` from ``es`` on a tick that makes no trainer call,
    as [(name, call)]. ``exp`` throttles its trainer (``train_every`` of 3
    or more) and ``es`` first ticks on to ``explr_step % train_every == 1``,
    so the checked tick and the one after it (a failed check's rerun) both
    fall between trainer calls; the call raises if it trained all the
    same. ``chip_smoke.py`` checks its production ticks through this."""
    if exp.train_every < 3:
        raise ValueError(f"train_every {exp.train_every}: every other tick may train")
    while es.explr_step % exp.train_every != 1:
        exp.tick(es)
    calls = es.learning_ind

    def tick():
        exp.tick(es)
        if es.learning_ind != calls:
            raise RuntimeError("the checked tick made a trainer call")

    return [("Experiment.tick", tick)]


def _replays(exp, es) -> bool:
    """The next tick replays its pattern's tick graph (on the card); always
    on the CPU, which has none."""
    return exp.tick_graph is None or (exp._tick_pattern(es), None) in exp.tick_graph.entries


def trained_tick(exp, es):
    """``Experiment.tick`` from ``es`` on a tick that makes a trainer call,
    as [(name, call)]: ``es`` first ticks on past the ticks that run
    eagerly or capture the experiment's tick graph on the card, so the
    checked tick replays it; the call
    raises if it made no trainer call. ``chip_smoke.py`` checks its
    production ticks through this."""
    while (es.explr_step % exp.train_every or es.learning_ind < 1
           or not _replays(exp, es)):
        exp.tick(es)
    calls = es.learning_ind

    def tick():
        exp.tick(es)
        if es.learning_ind != calls + 1:
            raise RuntimeError("the checked tick made no trainer call")

    return [("Experiment.tick with a trainer call", tick)]


def tick_parts(dev, **kw):
    """A toy ``Experiment`` on ``dev`` (``TOY`` with ``kw``) after 4 ticks,
    and its next tick that makes no trainer call."""
    exp = Experiment(ExperimentConfig(**{**TOY, **kw}), train_calls_per_tick=1, train_every=3,
                     device=dev)
    es = exp.init(seed=0)
    for _ in range(4):
        es, _ = exp.tick(es)
    return untrained_tick(exp, es)


@pytest.mark.parametrize("kw", [{}, {"states": "xyzrpw"},
                                {"states": "xywb", "learn_force": True, "use_z_ensemble": True},
                                {"sim_backend": "arm"}],
                         ids=["xyw", "xyzrpw", "xywb-force-ensemble", "arm"])
def test_warm_tick_makes_no_round_trip(kw):
    assert _round_trips(tick_parts("cpu", **kw)) == {}


@pytest.mark.parametrize("kw", [{}, {"states": "xywb", "learn_force": True,
                                     "use_z_ensemble": True}],
                         ids=["xyw", "xywb-force-ensemble"])
def test_warm_tick_with_a_trainer_call_makes_no_round_trip(monkeypatch, kw):
    """A tick whose trainer call runs, with the stock optimizer as the card
    builds it (capturable; torch refuses that on the CPU, so its device
    check admits the CPU here) and with FusedAdam: the eager call, whose
    launches a captured trainer call replays, reads nothing back, and
    neither does the entropy grade's fresh decode around it (the variant
    path, whose grade is not folded from the planner's decode)."""
    import torch.optim.adam as torch_adam
    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*supported(*a, **k), "cpu"])
    for fused in (False, True):
        exp = Experiment(ExperimentConfig(**{**TOY, **kw}), train_calls_per_tick=1,
                         train_every=3, device="cpu")
        exp.trainer = dataclasses.replace(exp.trainer, fused_adam=fused)
        es = exp.init(seed=0)
        if not fused:
            es.opt = torch.optim.Adam(es.model.parameters(), lr=exp.trainer.lr,
                                      capturable=True)
        assert _round_trips(trained_tick(exp, es)) == {}, fused


def host_loop_step(runner, es, trained=False):
    """One steady step of a device-resident ``HostLoopRunner`` (the composed
    step: command, observe, absorb, plan) from ``es``, as [(name, call)]:
    the runner first steps on until the next step holds a pending plan,
    makes a trainer call or none as ``trained`` asks, and (where the runner
    has a step graph) replays its pattern's graph; the call raises if it
    did not replay. ``chip_smoke.py`` checks its production steps through
    this."""
    from ealv_tpu_torch.runtime.graphs import _spec

    exp, g = runner.exp, runner.step_graph
    assert runner._cmd_absorb_plan is not None and runner.draws_fn is None

    def ready():
        if runner._pending is None or runner.pause.paused:
            return False
        if any(exp._throttle(es.explr_step, es.learning_ind)) != trained:
            return False
        return g is None or (runner._pattern(es, runner.bridge.state),
                             _spec(((), (None, None)))) in g.entries

    for _ in range(60):
        if ready():
            break
        runner.step(es)
    else:
        raise RuntimeError("no steady host-loop step to check in 60 steps")

    def step():
        replays = g.replays if g is not None else 0
        runner.step(es)
        if g is not None and g.replays != replays + 1:
            raise RuntimeError("the checked host-loop step did not replay its graph")

    return [("HostLoopRunner.step" + (" with a trainer call" if trained else ""), step)]


def serial_step(runner, es, trained=False):
    """The device work of one steady step of a serial ``HostLoopRunner``
    from ``es``, as [(name, call)]: the plan from the last observation
    (``_prime``) and the absorb of the next one, whose host tensors are put
    on the device before the calls (the serial step sends its command and
    takes its observation through the host by design). The runner first
    steps on until the absorb makes a trainer call or none as ``trained``
    asks and (where the runner has graphs) both the plan's and the absorb's
    patterns are captured; each call raises if it did not replay."""
    exp, plan_g, step_g = runner.exp, runner.plan_graph, runner.step_graph
    assert not runner.pipeline and runner.draws_fn is None

    def captured(g, pattern):
        return g is None or any(key[0] == pattern for key in g.entries)

    def ready():
        if runner._obs is None or runner.pause.paused:
            return False
        if any(exp._throttle(es.explr_step, es.learning_ind)) != trained:
            return False
        return (captured(plan_g, (es.explr_step < exp.cfg.prior_steps,))
                and captured(step_g, runner._pattern(es, None, plan=False)))

    for _ in range(60):
        if ready():
            break
        runner.step(es)
    else:
        raise RuntimeError("no steady serial step to check in 60 steps")
    pose, vel, force, img = runner._obs
    plan_in = runner._dev(pose, vel, runner._brightness(pose))
    absorb_in = runner._dev_obs(pose, vel, force, img)
    pending = []

    def replayed(g, call):
        replays = g.replays if g is not None else 0
        out = call()
        if g is not None and g.replays != replays + 1:
            raise RuntimeError("the checked serial step did not replay its graph")
        return out

    def plan():
        pending.append(replayed(plan_g, lambda: runner._prime(es, plan_in)))

    def absorb():
        pstate, cmd7, info = pending.pop()
        replayed(step_g, lambda: runner._step_absorb_plan(es, (pstate, info, cmd7),
                                                          inputs=absorb_in, plan=False))

    name = "serial HostLoopRunner.step" + (" with a trainer call" if trained else "")
    return [(f"{name}: plan", plan), (f"{name}: absorb", absorb)]


def host_loop_parts(dev):
    """A toy device-resident ``HostLoopRunner`` over a ``SyntheticBridge``
    on ``dev`` and its next steady step that makes no trainer call."""
    from ealv_tpu_torch.hw.bridge import SyntheticBridge
    from ealv_tpu_torch.runtime import HostLoopRunner

    exp = Experiment(ExperimentConfig(**TOY), train_calls_per_tick=1, train_every=3,
                     device=dev)
    es = exp.init(seed=0)
    runner = HostLoopRunner(exp, SyntheticBridge(exp.env, es.env))
    return host_loop_step(runner, es)


def test_steady_host_loop_step_makes_no_round_trip():
    assert _round_trips(host_loop_parts("cpu")) == {}


@pytest.mark.parametrize("trained", [False, True], ids=["untrained", "trained"])
def test_steady_serial_host_loop_step_makes_no_round_trip(monkeypatch, trained):
    """The serial step's plan and absorb (``serial_step``), its observation
    already on the device, with and without a trainer call (the stock
    optimizer as the card builds it, as in
    ``test_warm_tick_with_a_trainer_call_makes_no_round_trip``)."""
    import torch.optim.adam as torch_adam
    from ealv_tpu_torch.hw.bridge import SyntheticBridge
    from ealv_tpu_torch.runtime import HostLoopRunner

    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*supported(*a, **k), "cpu"])
    exp = Experiment(ExperimentConfig(**TOY), train_calls_per_tick=1, train_every=3,
                     device="cpu")
    es = exp.init(seed=0)
    es.opt = torch.optim.Adam(es.model.parameters(), lr=exp.trainer.lr, capturable=True)
    runner = HostLoopRunner(exp, SyntheticBridge(exp.env, es.env), pipeline=False)
    assert _round_trips(serial_step(runner, es, trained=trained)) == {}


def eval_parts(dev):
    """A toy ``EvalExperiment`` on ``dev`` toward an ExplrDist target after
    2 ticks, and its next tick."""
    ev_exp = EvalExperiment(ExperimentConfig(**TOY), lambda ctx, s: ctx.pdf(s), device=dev)
    target = make_capture_target("xyw", np.array([0.2, -0.3, 0.0], np.float32), "sphere",
                                 device=dev)
    ev = ev_exp.init(seed=0)
    for _ in range(2):
        ev, _ = ev_exp.tick(ev, target)
    return [("EvalExperiment.tick", lambda: ev_exp.tick(ev, target))]


def test_eval_tick_makes_no_round_trip():
    assert _round_trips(eval_parts("cpu")) == {}


def fingerprint_ticks(cfg, model, scene, fps, center, robot_lim, tray_lim, dev, warm=2):
    """A capture step (the eval tick toward the capture target at
    ``center``, std x 0.1, then the encoding of its observation) and an
    identification tick in each seek mode (the tick toward the adopted
    belief, the match and the fusion of ``FP_COMBOS``), each after ``warm``
    steps, as [(name, call)]: on the card each runtime's step graph has
    captured by then, and each call raises if its step did not replay.
    ``chip_smoke.py`` checks its production stage through this."""
    center = np.asarray(center, np.float32)
    cap, target, ev, mstate = capture_start(model, cfg, center, scene=scene, device=dev)
    st = {"ev": ev, "mstate": mstate}

    def capture_tick():
        st["ev"], st["mstate"], _ = capture_step(cap, model, target, st["ev"], st["mstate"])

    steps = [("capture step", cap, capture_tick)]
    for mode in ("fixed", "uncertain"):
        rt = FingerprintMatrixRuntime(cfg, model, fps, combos=FP_COMBOS, seek_mode=mode,
                                      update_tdist_step=0, scene=scene, device=dev)
        beliefs = [list(rt.beliefs[rt.combo_key(m, e)]) for m, e in FP_COMBOS]
        ev = {"ev": rt._ev.init(seed=7)}

        def id_tick(rt=rt, beliefs=beliefs, ev=ev, mode=mode):
            ev["ev"], *_ = _identification_tick(rt._ev, model, fps, cfg, FP_COMBOS, beliefs,
                                                rt.seek_combo, rt.seek_fingerprint, 0, 1,
                                                ev["ev"], robot_lim, tray_lim, mode)

        steps.append((f"identification tick ({mode})", rt._ev, id_tick))
    for _, _, step in steps:
        for _ in range(warm):
            step()

    def replayed(ev_exp, step):
        graph = ev_exp.tick_graph
        before = None if graph is None else graph.replays
        step()
        if graph is not None and graph.replays != before + 1:
            raise RuntimeError("the checked step did not replay its graph")

    return [(name, lambda ev_exp=ev_exp, step=step: replayed(ev_exp, step))
            for name, ev_exp, step in steps]


def fingerprint_parts(dev):
    """The fingerprint stage's ticks (``fingerprint_ticks``) at toy size on
    ``dev``: two fingerprints of 3 capture ticks each in a 2-object
    scene."""
    cfg = ExperimentConfig(**FP_TOY)
    model = CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                 hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
                 cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels,
                 compute_dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev)
    scene = TrayScene.make(2, seed=0, device=dev)
    centers = np.array([[0.2, -0.3, 0.0], [-0.4, 0.3, 0.5]], np.float32)
    fps = FingerprintSet.from_lists(
        [capture_fingerprint(model, cfg, c, scene=scene, num_steps=3, min_pose_dist=0.0,
                             seed=i, device=dev) for i, c in enumerate(centers)], device=dev)
    lims = torch.as_tensor(cfg.robot_lim, device=dev), torch.as_tensor(cfg.tray_lim, device=dev)
    return fingerprint_ticks(cfg, model, scene, fps, centers[0], *lims, dev)


def test_capture_and_identification_ticks_make_no_round_trip():
    assert _round_trips(fingerprint_parts("cpu")) == {}


def test_the_counter_sees_each_kind_of_round_trip():
    """The check itself: each kind it names is caught."""
    x = torch.arange(6.0)
    kinds = {"a tensor from Python data": lambda: torch.tensor([1.0, 2.0]),
             "a Python list index": lambda: x[[0, 2]],
             "a Python scalar written into one element": lambda: x.clone().__setitem__(2, 0.0),
             "a value read back": lambda: x.sum().item(),
             "nonzero": lambda: x.nonzero(),
             "boolean-mask index": lambda: x[x > 2]}
    for name, call in kinds.items():
        assert _round_trips([(name, call)]), name

"""The captured trainer and planner calls and the captured tick and
post-training call (``runtime/graphs.py``) against the eager calls on the
card, at toy size.

Every test needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py

Each test runs two experiments from the same seed, one with
its graphs set to None (the eager calls) and one with the graphs, through
the same calls, and compares them bit for bit: a captured call replays the
eager call's kernels on the same inputs. The trainer and planner calls'
own graphs are tested with the tick graphs set to None, the mode in which
``Experiment`` runs them in its tick. cuDNN is held to deterministic
algorithms here, so that two eager calls agree bit for bit too;
``chip_smoke.py`` holds the production call with cuDNN's default choice.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from ealv_tpu_torch.control import BaselineDraws
from ealv_tpu_torch.runtime import Experiment, PostTrainDraws, TickDraws, TrainDraws, \
    train_call
from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint, state_leaves
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_sync import TOY as SYNC_TOY, trained_tick

TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2, compute_dtype="float32")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _pair(kernels=False, ticks=False, train_every=1, drift_every=None, **kw):
    """The eager and the captured experiment, both from seed 0: the
    captured one runs its trainer and planner calls as their own graphs,
    or with ``ticks`` its whole ticks and post-training calls."""
    out = []
    for graphs in (False, True):
        cfg = ExperimentConfig(**{**TOY, **kw},
                               fast_encoder_grads="pallas" if kernels else False)
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=train_every,
                         device="cuda")
        if not (graphs and ticks):
            exp.tick_graph = exp.post_train_graph = None
        if not graphs:
            exp.trainer_graph = exp.planner_graph = None
        if drift_every is not None:
            exp.env = dataclasses.replace(exp.env, drift_every=drift_every)
        exp.trainer = dataclasses.replace(exp.trainer, fused_adam=kernels)
        out.append((exp, exp.init(seed=0)))
    return out


def _fill(es, cfg, n=12, seed=2):
    rng = np.random.default_rng(seed)
    lim = cfg.robot_lim
    for _ in range(n):
        es.buf.push(torch.tensor(rng.uniform(lim[:, 0], lim[:, 1]), dtype=torch.float32,
                                 device="cuda"),
                    torch.tensor(rng.uniform(0, 1, cfg.image_dim), dtype=torch.float32,
                                 device="cuda"))


def _draws(cfg, n, rng):
    steps, B = cfg.num_learning_opt, cfg.batch_size
    t = lambda a, dt: torch.tensor(a, dtype=dt, device="cuda")
    return TrainDraws(idx=t(rng.integers(0, n, (steps, B)), torch.int64),
                      idx2=t(rng.integers(0, n, (steps, B)), torch.int64),
                      eps=t(rng.standard_normal((steps, B, cfg.z_dim)), torch.float32))


def _assert_states_equal(a, b):
    for (path, x), (_, y) in zip(state_leaves(a), state_leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), path
        else:
            assert x == y, path


def _train(exp, es, beta, gamma, draws=None):
    """One trainer call, through the experiment's trainer graph if it has
    one."""
    train = exp.trainer_graph or train_call
    return train(exp.trainer, es.model, es.opt, es.buf, beta, gamma, generator=es.gen,
                 draws=draws)


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "K2-K3"])
def test_captured_trainer_call_is_bit_equal_on_fed_draws(cuda, kernels):
    """Four calls with other beta, gamma and fed draws each (eager, capture
    and replay, replay, replay): the metrics and the whole state equal the
    eager experiment's after every call; the capture recorded the toy
    call's kernel launches (2 K2 and 6 K3 with the kernels on)."""
    (exp_e, es_e), (exp_g, es_g) = _pair(kernels)
    for exp, es in ((exp_e, es_e), (exp_g, es_g)):
        _fill(es, exp.cfg)
    rng = np.random.default_rng(4)
    for i in range(4):
        beta = torch.tensor(0.01 * (i + 1), device="cuda")
        gamma = torch.tensor(0.5 / (i + 1), device="cuda")
        draws = _draws(exp_e.cfg, 12, rng)
        want = _train(exp_e, es_e, beta, gamma, draws)
        got = _train(exp_g, es_g, beta, gamma, draws)
        for k in want:
            assert torch.equal(want[k], got[k]), (i, k)
        _assert_states_equal(es_e, es_g)
    g = exp_g.trainer_graph
    assert (g.warmups, g.captures, g.replays) == (1, 1, 3)
    assert (g.recorded["adam_apply"], g.recorded["conv_wgrad_direct"]) == \
        ((2, 6) if kernels else (0, 0))
    assert g.launched["adam_apply"] == 3 * g.recorded["adam_apply"]


@pytest.mark.cuda
def test_replays_advance_the_registered_generator(cuda):
    """Trainer calls that draw their batches and noise from the
    experiment's generator: each replay draws what the eager call draws,
    so the generator is registered with the graph (unregistered, every
    replay would redraw the capture's numbers), and the generator ends in
    the eager run's state."""
    (exp_e, es_e), (exp_g, es_g) = _pair()
    for exp, es in ((exp_e, es_e), (exp_g, es_g)):
        _fill(es, exp.cfg)
    beta, gamma = torch.tensor(0.01, device="cuda"), torch.tensor(0.5, device="cuda")
    for i in range(4):
        want = _train(exp_e, es_e, beta, gamma)
        got = _train(exp_g, es_g, beta, gamma)
        for k in want:
            assert torch.equal(want[k], got[k]), (i, k)
    assert exp_g.trainer_graph.replays == 3
    assert torch.equal(es_e.gen.get_state(), es_g.gen.get_state())
    _assert_states_equal(es_e, es_g)


@pytest.mark.cuda
def test_a_dead_experiment_collected_inside_a_capture_does_not_fail_it(cuda):
    """An Experiment refers to itself (its planner holds its bound
    ``_pdf``), so a dropped one is freed, captured graphs included, only
    by Python's cyclic collector, which may run at any allocation.
    Destroying a graph inside another capture invalidates that capture;
    the capture collects first. Here the forward pass collects inside the
    capture while a dead experiment with a captured graph waits."""
    beta, gamma = torch.tensor(0.01, device="cuda"), torch.tensor(0.5, device="cuda")
    gc.disable()  # the dead experiment waits until a collection is asked for
    try:
        old_exp, old_es = _pair()[1]
        _fill(old_es, old_exp.cfg)
        for _ in range(2):
            _train(old_exp, old_es, beta, gamma)
        assert old_exp.trainer_graph.captures == 1
        dead = weakref.ref(old_exp.trainer_graph)
        del old_exp, old_es
        exp, es = _pair()[1]
        _fill(es, exp.cfg)
        _train(exp, es, beta, gamma)  # eager: the next call captures
        assert dead() is not None
        def collect(*_):  # returns None: the forward's arguments stay
            gc.collect()

        es.model.register_forward_pre_hook(collect)
        for _ in range(2):
            got = _train(exp, es, beta, gamma)
        assert dead() is None
    finally:
        gc.enable()
    g = exp.trainer_graph
    assert (g.warmups, g.captures, g.replays) == (1, 1, 2)
    assert all(torch.isfinite(v.float()).all() for v in got.values())


@pytest.mark.cuda
def test_load_checkpoint_forces_a_recapture(cuda, tmp_path):
    """After load_checkpoint (which rebuilds the ring's and the optimizer's
    tensors) the next trainer call runs eagerly and the one after it
    captures anew, and the run goes on as the eager run that loads the
    same checkpoint."""
    (exp_e, es_e), (exp_g, es_g) = _pair()
    for _ in range(5):
        exp_g.tick(es_g)
    g = exp_g.trainer_graph
    assert g.captures == 1
    ck = save_checkpoint(str(tmp_path / "c"), es_g)
    es_e = load_checkpoint(ck, exp_e.init(seed=0))
    es_g = load_checkpoint(ck, exp_g.init(seed=0))
    for _ in range(3):
        exp_e.tick(es_e)
        exp_g.tick(es_g)
    assert (g.warmups, g.captures) == (2, 2)
    _assert_states_equal(es_e, es_g)


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["xyw", "xyzrpw"])
def test_captured_plan_step_is_bit_equal(cuda, states):
    """Five ticks with the planner and trainer calls captured against the
    eager ticks: the plan, the planner's info and the state bit for bit
    after every tick. Each tick plans twice (once alone, once in the tick),
    so the planner graph runs eagerly once, captures once and replays on
    nine calls."""
    (exp_e, es_e), (exp_g, es_g) = _pair(states=states)
    for i in range(5):
        full_e = exp_e._measured_robot_state(es_e.env)
        full_g = exp_g._measured_robot_state(es_g.env)
        pe, ve, _, ie = exp_e.plan_step(es_e, full_e)
        pg, vg, _, ig = exp_g.plan_step(es_g, full_g)
        assert torch.equal(pe.u, pg.u) and torch.equal(ve, vg), i
        for k in ie:
            assert torch.equal(ie[k], ig[k]), (i, k)
        exp_e.tick(es_e)
        exp_g.tick(es_g)
        _assert_states_equal(es_e, es_g)
    p = exp_g.planner_graph
    assert (p.warmups, p.captures, p.replays) == (1, 1, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("ticks", [False, True], ids=["per-call-graphs", "tick-graph"])
@pytest.mark.parametrize("kw", [{}, {"states": "xywb", "learn_force": True,
                                     "use_z_ensemble": True, "fast_encoder_grads": "pallas"}],
                         ids=["xyw", "xywb-force-ensemble-K3"])
def test_warm_toy_tick_with_a_replayed_trainer_call_never_synchronises(cuda, kw, ticks):
    """A toy tick with a trainer call (``test_torch_sync.trained_tick``)
    that replays its graphs (the planner's and the trainer's, or the whole
    tick's), under ``torch.cuda.set_sync_debug_mode("error")``: no call of
    the tick makes the host wait for the card."""
    exp = Experiment(ExperimentConfig(**{**SYNC_TOY, **kw}), train_calls_per_tick=1,
                     train_every=3, device="cuda")
    if not ticks:
        exp.tick_graph = exp.post_train_graph = None
    parts = trained_tick(exp, exp.init(seed=0))
    if ticks:
        assert exp.tick_graph.captures >= 2 and exp.trainer_graph.captures == 0
    else:
        assert exp.trainer_graph.captures == 1 and exp.planner_graph.captures == 1
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _, call in parts:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _fed(cfg, k, rng):
    """Valid fed draws for tick ``k`` of a toy run whose rings do not wrap
    (as ``chip_smoke._toy_draws``): history and batch indices among the
    filled slots, samples in the robot limits."""
    lim = cfg.robot_lim
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device="cuda")
    hist = np.concatenate([rng.permutation(k + 1),
                           k + 1 + rng.permutation(cfg.traj_buffer_capacity - k - 1)])
    steps, B = cfg.num_learning_opt, cfg.batch_size
    train = TrainDraws(idx=t(rng.integers(0, k + 1, (steps, B)), torch.int64),
                       idx2=t(rng.integers(0, k + 1, (steps, B)), torch.int64),
                       eps=t(rng.standard_normal((steps, B, cfg.z_dim))))
    grade = t(rng.uniform(lim[:, 0], lim[:, 1], (cfg.num_target_samples, cfg.s_dim)))
    return TickDraws(samples=t(rng.uniform(lim[:, 0], lim[:, 1],
                                           (cfg.num_target_samples, cfg.s_dim))),
                     hist_idx=t(hist[: cfg.num_traj_samples], torch.int64), train=[train],
                     grade_samples=[grade],
                     baseline=BaselineDraws(cands=t(rng.uniform(size=(10, cfg.s_dim))),
                                            state_u=t(rng.uniform(size=cfg.s_dim))))


TICK_PATHS = {"xyw": {}, "xyzrpw": dict(states="xyzrpw"),
              "xywb-force-ensemble-K2-K3": dict(states="xywb", learn_force=True,
                                                use_z_ensemble=True, kernels=True),
              "arm-drift": dict(sim_backend="arm", drift_every=2),
              "uniform": dict(explr_method="uniform")}


@pytest.mark.cuda
@pytest.mark.parametrize("fed", [False, True], ids=["generator", "fed"])
@pytest.mark.parametrize("path", list(TICK_PATHS))
def test_captured_tick_is_bit_equal(cuda, path, fed):
    """Ten ticks (a trainer call every third; on the arm a drift correction
    every second command, so four patterns) through the tick graph against
    the eager ticks, on the generators' draws or on fed draws: every tick's
    info (compared after the last tick) and the state after every tick, bit
    for bit; then three post-training calls. Each pattern captures once its
    second tick comes, and the later ticks replay."""
    (exp_e, es_e), (exp_g, es_g) = _pair(ticks=True, train_every=3, **TICK_PATHS[path])
    rng = np.random.default_rng(3)
    infos = ([], [])
    for k in range(10):
        draws = _fed(exp_e.cfg, k, rng) if fed else None
        for (exp, es), out in zip(((exp_e, es_e), (exp_g, es_g)), infos):
            out.append(exp.tick(es, draws)[1])
        _assert_states_equal(es_e, es_g)
    for k, (a, b) in enumerate(zip(*infos)):
        for key in a:
            assert torch.equal(a[key], b[key]), (k, key)
    g = exp_g.tick_graph
    assert g.captures >= 2 and g.replays >= 4 and g.warmups + g.replays == 10
    if path == "arm-drift":
        assert {p[2] for p in g.counts} == {(True,), (False,)}
    rows = [exp.post_train_chunk(es, 3)[1] for exp, es in ((exp_e, es_e), (exp_g, es_g))]
    for key in rows[0]:
        assert torch.equal(rows[0][key], rows[1][key]), key
    _assert_states_equal(es_e, es_g)
    assert exp_g.post_train_graph.counts == {(): [1, 1, 2]}


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "K2-K3"])
def test_captured_post_training_call_is_bit_equal(cuda, kernels):
    """Four post-training calls on fed draws over a filled ring (an eager
    call, a capture and its replay, two replays) against the eager calls:
    the rows after the last call and the state after each, bit for bit;
    the capture recorded the toy call's launches (1 K1 for the grade's
    spread; 2 K2 and 6 K3 with the kernels on)."""
    (exp_e, es_e), (exp_g, es_g) = _pair(kernels, ticks=True)
    for exp, es in ((exp_e, es_e), (exp_g, es_g)):
        _fill(es, exp.cfg)
    rng = np.random.default_rng(6)
    lim, cfg = exp_e.cfg.robot_lim, exp_e.cfg
    draws = [PostTrainDraws(samples=torch.tensor(
        rng.uniform(lim[:, 0], lim[:, 1], (cfg.num_target_samples, cfg.s_dim)),
        dtype=torch.float32, device="cuda"), train=_draws(cfg, 12, rng)) for _ in range(4)]
    rows = ([], [])
    for d in draws:
        for (exp, es), out in zip(((exp_e, es_e), (exp_g, es_g)), rows):
            out.append(exp.post_train_chunk(es, 1, [d])[1])
        _assert_states_equal(es_e, es_g)
    for a, b in zip(*rows):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    g = exp_g.post_train_graph
    assert g.counts == {(): [1, 1, 3]}
    (entry,) = g.entries.values()
    assert entry.recorded == {"footprint_and_spread": 1, "adam_apply": 2 if kernels else 0,
                              "conv_wgrad_direct": 6 if kernels else 0}

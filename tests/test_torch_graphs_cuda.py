"""The captured trainer and planner calls (``runtime/graphs.py``) against
the eager calls on the card, at toy size.

Every test needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py

Each test runs two experiments from the same seed, one with
its graphs set to None (the eager calls) and one with the graphs, through
the same calls, and compares them bit for bit: a captured call replays the
eager call's kernels on the same inputs. cuDNN is held to deterministic
algorithms here, so that two eager calls agree bit for bit too;
``chip_smoke.py`` holds the production call with cuDNN's default choice.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from ealv_tpu_torch.runtime import Experiment, TrainDraws, train_call
from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint, state_leaves
from ealv_tpu_torch.utils.config import ExperimentConfig

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


def _pair(kernels=False, **kw):
    """The eager and the captured experiment, both from seed 0."""
    out = []
    for graphs in (False, True):
        cfg = ExperimentConfig(**{**TOY, **kw},
                               fast_encoder_grads="pallas" if kernels else False)
        exp = Experiment(cfg, train_calls_per_tick=1, device="cuda")
        if not graphs:
            exp.trainer_graph = exp.planner_graph = None
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
@pytest.mark.parametrize("kw", [{}, {"states": "xywb", "learn_force": True,
                                     "use_z_ensemble": True, "fast_encoder_grads": "pallas"}],
                         ids=["xyw", "xywb-force-ensemble-K3"])
def test_warm_toy_tick_with_a_replayed_trainer_call_never_synchronises(cuda, kw):
    """A toy tick whose planner and trainer calls replay their graphs
    (``test_torch_sync.trained_tick``), under
    ``torch.cuda.set_sync_debug_mode("error")``: no call of the tick makes
    the host wait for the card."""
    from test_torch_sync import TOY as SYNC_TOY, trained_tick
    exp = Experiment(ExperimentConfig(**{**SYNC_TOY, **kw}), train_calls_per_tick=1,
                     train_every=3, device="cuda")
    parts = trained_tick(exp, exp.init(seed=0))
    assert exp.trainer_graph.captures == 1 and exp.planner_graph.captures == 1
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _, call in parts:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

"""The captured tick and post-training call, the host loop's captured
steps, and the eval runtime's captured steps (the eval tick, the
fingerprint capture, the identification run) (``runtime/graphs.py``
``StepGraph``s) against the eager steps on the card, at toy size.

Every test needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_cuda.py

Each test runs two experiments from the same seed, one with
its graphs set to None (the eager steps) and one with the graphs, through
the same calls, and compares them bit for bit: a captured step replays the
eager step's kernels on the same inputs. A trainer call is captured inside
the post-training call's graph. cuDNN is held to deterministic
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
from ealv_tpu_torch.runtime import Experiment, PostTrainDraws, TickDraws, TrainDraws
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


def _pair(kernels=False, train_every=1, drift_every=None, **kw):
    """The eager and the captured experiment, both from seed 0: the
    captured one runs its ticks and post-training calls as graphs."""
    out = []
    for graphs in (False, True):
        cfg = ExperimentConfig(**{**TOY, **kw},
                               fast_encoder_grads="pallas" if kernels else False)
        exp = Experiment(cfg, train_calls_per_tick=1, train_every=train_every,
                         device="cuda")
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
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


def _post_draws(cfg, rng):
    lim = cfg.robot_lim
    return PostTrainDraws(samples=torch.tensor(
        rng.uniform(lim[:, 0], lim[:, 1], (cfg.num_target_samples, cfg.s_dim)),
        dtype=torch.float32, device="cuda"), train=_draws(cfg, 12, rng))


def _train(exp, es, draws=None):
    """One post-training call (a grade, beta and gamma moved, one trainer
    call), through the experiment's post-training graph if it has one."""
    return exp.post_train_chunk(es, 1, None if draws is None else [draws])[1]


@pytest.mark.cuda
def test_replays_advance_the_registered_generator(cuda):
    """Post-training calls that draw their grade samples, batches and noise
    from the experiment's generator: each replay draws what the eager call
    draws, so the generator is registered with the graph (unregistered,
    every replay would redraw the capture's numbers), and the generator
    ends in the eager run's state."""
    (exp_e, es_e), (exp_g, es_g) = _pair()
    for exp, es in ((exp_e, es_e), (exp_g, es_g)):
        _fill(es, exp.cfg)
    for i in range(4):
        want = _train(exp_e, es_e)
        got = _train(exp_g, es_g)
        for k in want:
            assert torch.equal(want[k], got[k]), (i, k)
    assert exp_g.post_train_graph.replays == 3
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
    gc.disable()  # the dead experiment waits until a collection is asked for
    try:
        old_exp, old_es = _pair()[1]
        _fill(old_es, old_exp.cfg)
        for _ in range(2):
            _train(old_exp, old_es)
        assert old_exp.post_train_graph.captures == 1
        dead = weakref.ref(old_exp.post_train_graph)
        del old_exp, old_es
        exp, es = _pair()[1]
        _fill(es, exp.cfg)
        _train(exp, es)  # eager: the next call captures
        assert dead() is not None
        def collect(*_):  # returns None: the forward's arguments stay
            gc.collect()

        es.model.register_forward_pre_hook(collect)
        for _ in range(2):
            got = _train(exp, es)
        assert dead() is None
    finally:
        gc.enable()
    g = exp.post_train_graph
    assert (g.warmups, g.captures, g.replays) == (1, 1, 2)
    assert all(torch.isfinite(v.float()).all() for v in got.values())


@pytest.mark.cuda
def test_load_checkpoint_forces_a_recapture(cuda, tmp_path):
    """After load_checkpoint (which rebuilds the ring's and the optimizer's
    tensors) the next post-training call runs eagerly and the one after it
    captures anew, and the run goes on as the eager run that loads the
    same checkpoint."""
    (exp_e, es_e), (exp_g, es_g) = _pair()
    _fill(es_g, exp_g.cfg)
    for _ in range(3):
        _train(exp_g, es_g)
    g = exp_g.post_train_graph
    assert g.captures == 1
    ck = save_checkpoint(str(tmp_path / "c"), es_g)
    es_e = load_checkpoint(ck, exp_e.init(seed=0))
    es_g = load_checkpoint(ck, exp_g.init(seed=0))
    for _ in range(3):
        _train(exp_e, es_e)
        _train(exp_g, es_g)
    assert (g.warmups, g.captures) == (2, 2)
    _assert_states_equal(es_e, es_g)


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["xyw", "xyzrpw"])
def test_captured_plan_step_is_bit_equal(cuda, states):
    """Six serial host-loop steps, each planned through the host loop's
    plan graph, against the eager runner's: before each step a plan from
    the step's observation alone, then the step (which plans from that
    observation again); the plan, its command, the planner's info and the
    state bit for bit after every step. The plans replay from the steady
    steps on."""
    pair = _runner_pair("serial", states=states)
    (r_e, es_e), (r_g, es_g) = pair
    for i in range(6):
        plans = []
        for runner, es in pair:
            if runner._obs is None:
                runner._obs = runner.bridge.observe()
            plans.append(runner._plan_obs(es, runner._obs))
        (pe, ce, ie), (pg, cg, ig) = plans
        assert torch.equal(pe.u, pg.u) and torch.equal(ce, cg), i
        for k in ie:
            assert torch.equal(ie[k], ig[k]), (i, k)
        for runner, es in pair:
            runner.step(es)
        _assert_states_equal(es_e, es_g)
    p = r_g.plan_graph
    assert p.captures >= 1 and p.replays >= 6, p.counts


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"states": "xywb", "learn_force": True,
                                     "use_z_ensemble": True, "fast_encoder_grads": "pallas"}],
                         ids=["xyw", "xywb-force-ensemble-K3"])
def test_warm_toy_tick_with_a_replayed_trainer_call_never_synchronises(cuda, kw):
    """A toy tick with a trainer call (``test_torch_sync.trained_tick``)
    that replays its tick graph, under
    ``torch.cuda.set_sync_debug_mode("error")``: no call of the tick makes
    the host wait for the card."""
    exp = Experiment(ExperimentConfig(**{**SYNC_TOY, **kw}), train_calls_per_tick=1,
                     train_every=3, device="cuda")
    parts = trained_tick(exp, exp.init(seed=0))
    assert exp.tick_graph.captures >= 2
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
    (exp_e, es_e), (exp_g, es_g) = _pair(train_every=3, **TICK_PATHS[path])
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
    (exp_e, es_e), (exp_g, es_g) = _pair(kernels)
    for exp, es in ((exp_e, es_e), (exp_g, es_g)):
        _fill(es, exp.cfg)
    rng = np.random.default_rng(6)
    draws = [_post_draws(exp_e.cfg, rng) for _ in range(4)]
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
                              "conv_wgrad_direct": 6 if kernels else 0,
                              "horizon_rollout": 0, "costate_sweep": 0, "fuse_beliefs": 0}


# ------------------------------------------------------------ the eval runtime's steps

def _leaves(tree, path=""):
    """[(path, value)] of every tensor and plain value in ``tree``; a
    generator as its state."""
    from ealv_tpu_torch.runtime import graphs as tg
    if isinstance(tree, torch.Generator):
        return [(path, tree.get_state())]
    if isinstance(tree, torch.Tensor) or tg._leaf(tree) or isinstance(tree, torch.nn.Module):
        return [(path, tree)]
    return [leaf for k, v in tg._fields(tree)[1] for leaf in _leaves(v, f"{path}.{k}")]


def _bit_equal(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x.nan_to_num(), y.nan_to_num()) and torch.equal(
                x.isnan(), y.isnan()), f"{what}{path}"
        elif not isinstance(x, torch.nn.Module):
            assert x == y, f"{what}{path}"


FP_TOY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
              cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
              num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
              compute_dtype="float32")


def _fp_model(cfg):
    from ealv_tpu_torch.models import CVAE
    model = CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                 hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
                 cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to("cuda")


def _eval_fed(ev, cfg, k, rng):
    lims = ev.pstate.lims.cpu().numpy()
    hist = np.concatenate([rng.permutation(k + 1),
                           k + 1 + rng.permutation(cfg.traj_buffer_capacity - k - 1)])
    return TickDraws(samples=torch.tensor(rng.uniform(lims[:, 0], lims[:, 1], (
        cfg.num_target_samples, lims.shape[0])), dtype=torch.float32, device="cuda"),
                     hist_idx=torch.tensor(hist[: cfg.num_traj_samples], device="cuda"))


EVAL_PATHS = {"xyw-cvae": dict(states="xyw"), "xyzrpw-explr": dict(states="xyzrpw"),
              "arm-drift": dict(states="xyw", sim_backend="arm")}


@pytest.mark.cuda
@pytest.mark.parametrize("fed", [False, True], ids=["generator", "fed"])
@pytest.mark.parametrize("path", list(EVAL_PATHS))
def test_captured_eval_tick_is_bit_equal(cuda, path, fed):
    """Eight EvalExperiment ticks through the tick graph against the eager
    ticks (``tick_graph`` set to None), toward a frozen CVAE's pdf or an
    ExplrDist, on the planner's generator or on fed draws; on the arm a
    drift correction every second command, so the drift key flips every
    tick and both patterns replay. Every tick's observation (compared
    after the last) and the eval state after every tick, bit for bit."""
    from ealv_tpu_torch.control import ExplrDist
    from ealv_tpu_torch.models import init_model_state, update_dist
    from ealv_tpu_torch.runtime import EvalExperiment
    cfg = ExperimentConfig(**{**FP_TOY, **EVAL_PATHS[path]})
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    if path == "xyw-cvae":
        model = _fp_model(cfg)
        ms, _ = update_dist(model, init_model_state(model, "cuda"), t(rng.uniform(-1, 1, 3)),
                            t(rng.uniform(0, 1, cfg.image_dim)))
        fn, ctx = (lambda c, s: c[0].pdf(c[1], s)), (model, ms)
    else:
        ctx = ExplrDist.create(8, cfg.s_dim, device="cuda")
        for _ in range(3):
            ctx = ctx.push(t(rng.uniform(-0.6, 0.6, cfg.s_dim)),
                           t(rng.uniform(0.02, 0.08, cfg.s_dim)))
        fn = lambda c, s: c.pdf(s)
    runs = []
    for graphs in (False, True):
        ev_exp = EvalExperiment(cfg, fn, device="cuda")
        if path == "arm-drift":
            ev_exp.env = dataclasses.replace(ev_exp.env, drift_every=2)
        if not graphs:
            ev_exp.tick_graph = None
        runs.append([ev_exp, ev_exp.init(seed=2), []])
    for k in range(8):
        draws = _eval_fed(runs[0][1], cfg, k, rng) if fed else None
        for run in runs:
            run[1], obs = run[0].tick(run[1], ctx, draws)
            run[2].append(obs)
        _bit_equal(runs[0][1], runs[1][1], f"tick {k} ")
    _bit_equal(runs[0][2], runs[1][2], "observations ")
    g = runs[1][0].tick_graph
    assert g.warmups + g.replays == 8 and g.replays >= 4
    if path == "arm-drift":
        assert {p[-1] for p in g.counts} == {(True,), (False,)}
        assert all(c[2] >= 2 for c in g.counts.values())


@pytest.mark.cuda
def test_captured_capture_is_bit_equal(cuda):
    """Six capture steps (the eval tick toward the sphere target, then the
    encode) through the capture's step graph against the eager steps: every
    step's latents, robot state and first image, the final eval state and
    model state, bit for bit; then the public capture_fingerprint (its
    EvalExperiment captures inside the call) against the eager steps'
    fingerprint."""
    from ealv_tpu_torch.fingerprint import capture as tcap
    cfg = ExperimentConfig(**FP_TOY)
    model = _fp_model(cfg)
    center = np.array([0.2, -0.3, 0.1], np.float32)
    runs = []
    for graphs in (False, True):
        ev_exp, target, ev, ms = tcap.capture_start(model, cfg, center, seed=1, device="cuda")
        if not graphs:
            ev_exp.tick_graph = None
        outs = []
        for i in range(6):
            ev, ms, out = tcap.capture_step(ev_exp, model, target, ev, ms, first=i == 0)
            outs.append(out)
        runs.append((outs, ev, ms, ev_exp.tick_graph))
    for what, i in (("outs ", 0), ("eval state ", 1), ("model state ", 2)):
        _bit_equal(runs[0][i], runs[1][i], what)
    assert runs[1][3].replays == 4
    want = tcap.finish_capture([o[:3] for o in runs[0][0]], runs[0][0][0][3], center, 0.0)
    got = tcap.capture_fingerprint(model, cfg, center, num_steps=6, min_pose_dist=0.0, seed=1,
                                   device="cuda")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("update_every", [1, 2])
@pytest.mark.parametrize("seek_mode", ["fixed", "uncertain"])
def test_captured_identification_run_is_bit_equal(cuda, seek_mode, update_every):
    """Ten identification ticks of the matrix runtime over the four
    combinations, adoption at step 3 (two to four patterns), through the
    tick graph against the eager run: the history, the adopted objects and
    the returned beliefs bit for bit; the returned beliefs are not the
    graph's static buffers."""
    from ealv_tpu_torch.fingerprint import FingerprintBelief, FingerprintSet, \
        calibrate_thresholds
    from ealv_tpu_torch.fingerprint.test_runtime import FingerprintMatrixRuntime
    cfg = ExperimentConfig(**FP_TOY)
    model = _fp_model(cfg)
    rng = np.random.default_rng(12)
    dicts = [{"z_mu": rng.standard_normal((s, 8)).astype(np.float32) + 2.0 * i,
              "z_var": rng.uniform(-2.0, 0.5, (s, 8)).astype(np.float32),
              "x": rng.uniform(-1, 1, (s, 3)).astype(np.float32),
              "center": rng.uniform(-0.5, 0.5, 3).astype(np.float32),
              "center_img": rng.uniform(0, 1, cfg.image_dim).astype(np.float32)}
             for i, s in enumerate((5, 4))]
    fps = FingerprintSet.from_lists(dicts, device="cuda")
    combos = (("L2", False), ("KL", False), ("BC", False), ("L2", True))
    runs = []
    for graphs in (False, True):
        beliefs = {}
        for m, e in combos:
            th, cl = calibrate_thresholds(fps, m)
            beliefs[f"{m}_error" if e else m] = [FingerprintBelief.create(
                cfg.states, cfg.robot_lim, num_samples=12, meas_capacity=8, thresh=th, clip=cl,
                device="cuda") for _ in range(2)]
        rt = FingerprintMatrixRuntime(cfg, model, fps, combos=combos, seek_mode=seek_mode,
                                      update_tdist_step=3, beliefs=beliefs, device="cuda")
        if not graphs:
            rt._ev.tick_graph = None
        runs.append((rt, *rt.run(10, seed=5, update_every=update_every)))
    (rt_e, b_e, h_e), (rt_g, b_g, h_g) = runs
    for a, b in zip(h_e, h_g, strict=True):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_array_equal(rt_e.seek_history, rt_g.seek_history)
    _bit_equal(b_e, b_g, "beliefs ")
    g = rt_g._ev.tick_graph
    assert len(g.counts) == 2 * update_every and g.replays >= 10 - 4 * update_every
    ptrs = lambda tree: {v.data_ptr() for _, v in _leaves(tree)
                         if isinstance(v, torch.Tensor) and v.numel()}
    assert not ptrs(g.carry) & ptrs(b_g)


def _runner_pair(form, **kw):
    """The eager and the captured host loop over a toy ``SyntheticBridge``
    (``TOY`` with ``kw``), both from seed 0 with a trainer call every third
    step: the captured one with its plan and step graphs (the default on
    the card), the eager one with those and the experiment's graphs set to
    None. ``form`` "device" is the composed device-resident step, "host"
    the host-pipelined one (the observation copied to the host and
    staged), "serial" the serial one (plan, command, observe, absorb)."""
    from ealv_tpu_torch.hw.bridge import SyntheticBridge
    from ealv_tpu_torch.runtime import HostLoopRunner
    out = []
    for graphs in (False, True):
        exp = Experiment(ExperimentConfig(**{**TOY, **kw}), train_calls_per_tick=1,
                         train_every=3, device="cuda")
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
        es = exp.init(seed=0)
        runner = HostLoopRunner(exp, SyntheticBridge(exp.env, es.env),
                                pipeline=form != "serial", device_fast=form == "device")
        for g in (runner.plan_graph, runner.step_graph):
            assert g is not None and g.pool is exp.graph_pool
        if not graphs:
            runner.plan_graph = runner.step_graph = None
        out.append((runner, es))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["device", "host", "serial"])
def test_captured_host_loop_step_is_bit_equal(cuda, form):
    """Fourteen host-loop steps with pauses before steps 5 and 9 (the plan
    in flight dropped, the next primed through the plan graph) through the
    plan and step graphs against the eager runner: the state and the
    pending command after every step, bit for bit; the steady steps replay
    their pattern's graph, and so does a plan primed after a pause (the
    second one in the pipelined forms: the first trainer call, between the
    first two primes, makes the optimizer's moments that the graphs' base
    key holds); the experiment's planner generator and ring are the same
    objects throughout, and the fork's generator is registered with the
    graphs."""
    pair = _runner_pair(form)
    (r_e, es_e), (r_g, es_g) = pair
    gen = es_g.pstate.gen
    primes = []
    for k in range(14):
        for runner, es in pair:
            if k in (5, 9):
                runner.pause.pause()
            if k in (6, 10):
                runner.pause.resume()
            replays = runner.plan_graph.replays if runner.plan_graph is not None else 0
            runner.step(es)
            if runner is r_g and k in (6, 10):
                primes.append(runner.plan_graph.replays - replays)
        _assert_states_equal(es_e, es_g)
        assert (r_e._pending is None) == (r_g._pending is None), k
        if r_e._pending is not None:
            assert torch.equal(r_e._pending[2], r_g._pending[2]), k
    g = r_g.step_graph
    assert g.replays >= 5 and g.captures >= 2, g.counts
    assert es_g.pstate.gen is gen and es_g.explr_step == 12
    for graph in (g, r_g.plan_graph):
        assert any(x is r_g._fork_generator for x in graph.base)
    assert primes[1] == 1 and (form != "serial" or primes[0] == 1), primes


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["device", "serial"])
@pytest.mark.parametrize("trained", [False, True], ids=["untrained", "trained"])
def test_replayed_host_loop_step_never_synchronises(cuda, trained, form):
    """A host-loop step that replays its graphs, with and without a trainer
    call, under ``torch.cuda.set_sync_debug_mode("error")``: the
    device-resident step (``test_torch_sync.host_loop_step``), and the
    serial step's plan and absorb (``test_torch_sync.serial_step``; its
    command and observation cross the host by design)."""
    from test_torch_sync import host_loop_step, serial_step
    runner, es = _runner_pair(form)[1]
    parts = (host_loop_step if form == "device" else serial_step)(runner, es, trained=trained)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _, call in parts:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.fixture
def nccl(cuda, tmp_path):
    """A one-rank NCCL group over the card and its mesh, destroyed after
    the test."""
    import torch.distributed as dist
    from ealv_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "K2-K3"])
def test_captured_dp_train_call_is_bit_equal(nccl, kernels):
    """Four post-training calls on one NCCL rank, each one data-parallel
    trainer call, on fed draws, through the post-training graph (eager,
    capture and replay, replay, replay) against the eager calls: the rows
    and the state after every call bit for bit; the all-reduces are inside
    the graph."""
    runs = []
    for graphs in (False, True):
        cfg = ExperimentConfig(**TOY, fast_encoder_grads="pallas" if kernels else False)
        exp = Experiment(cfg, train_calls_per_tick=1, device="cuda", mesh=nccl)
        exp.trainer = dataclasses.replace(exp.trainer, fused_adam=kernels)
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
        es = exp.init(seed=0)
        _fill(es, exp.cfg)
        runs.append((exp, es))
    (exp_e, es_e), (exp_g, es_g) = runs
    rng = np.random.default_rng(4)
    for i in range(4):
        draws = _post_draws(exp_e.cfg, rng)
        want = _train(exp_e, es_e, draws)
        got = _train(exp_g, es_g, draws)
        for k in want:
            assert torch.equal(want[k], got[k]), (i, k)
        _assert_states_equal(es_e, es_g)
    g = exp_g.post_train_graph
    assert g.counts == {(): [1, 1, 3]}
    (entry,) = g.entries.values()
    assert entry.recorded["adam_apply"] == (2 if kernels else 0)


@pytest.mark.cuda
def test_captured_mesh_tick_is_bit_equal(nccl):
    """Ten ticks over the one-rank NCCL mesh (the decode through
    ``sharded_pdf``, the trainer through ``dp_train_call``) through the
    tick graph against the eager mesh ticks, then three post-training
    calls: bit for bit; a replayed tick with a trainer call makes no
    synchronising call. A gloo mesh on the card builds no graph."""
    import torch.distributed as dist
    from ealv_tpu_torch.parallel import Mesh
    runs = []
    for graphs in (False, True):
        exp = Experiment(ExperimentConfig(**TOY), train_calls_per_tick=1, train_every=3,
                         device="cuda", mesh=nccl)
        assert exp.eager_reason is None and len(exp.graphs()) == 2
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
        runs.append((exp, exp.init(seed=0)))
    infos = [exp.run_chunk(es, 10)[1] for exp, es in runs]
    for k in infos[0]:
        assert torch.equal(infos[0][k], infos[1][k]), k
    _assert_states_equal(runs[0][1], runs[1][1])
    rows = [exp.post_train_chunk(es, 3)[1] for exp, es in runs]
    for k in rows[0]:
        assert torch.equal(rows[0][k], rows[1][k]), k
    _assert_states_equal(runs[0][1], runs[1][1])
    g = runs[1][0].tick_graph
    assert g.captures >= 2 and g.replays >= 4
    parts = trained_tick(*runs[1])
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _, call in parts:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    gloo = Mesh(group=dist.new_group([0], backend="gloo"), rank=0, size=1,
                device=torch.device("cuda", 0))
    exp = Experiment(ExperimentConfig(**TOY), device="cuda", mesh=gloo)
    assert exp.eager_reason == "a gloo mesh" and exp.graphs() == []


MODEL_OPTIONS = {"subpixel": dict(decoder_mode="subpixel"),
                 "resize_conv": dict(decoder_mode="resize_conv"),
                 "s2d": dict(fast_encoder_grads="s2d"), "im2col": dict(fast_encoder_grads="im2col"),
                 "lane-pad-8": dict(lane_pad=8)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODEL_OPTIONS))
def test_captured_trainer_call_is_bit_equal_per_model_option(cuda, name):
    """The CVAE's options (decoder modes, encoder schedules, lane padding)
    in the captured trainer call: four post-training calls on fed draws
    through the post-training graph (eager, capture and replay, replay,
    replay), the rows and the whole state equal to the eager experiment's
    after every call."""
    runs = []
    for graphs in (False, True):
        exp = Experiment(ExperimentConfig(**{**TOY, **MODEL_OPTIONS[name]}),
                         train_calls_per_tick=1, train_every=1, device="cuda")
        if not graphs:
            exp.tick_graph = exp.post_train_graph = None
        es = exp.init(seed=0)
        _fill(es, exp.cfg)
        runs.append((exp, es))
    (exp_e, es_e), (exp_g, es_g) = runs
    rng = np.random.default_rng(4)
    for i in range(4):
        draws = _post_draws(exp_e.cfg, rng)
        want = _train(exp_e, es_e, draws)
        got = _train(exp_g, es_g, draws)
        for k in want:
            assert torch.equal(want[k], got[k]), (i, k)
        _assert_states_equal(es_e, es_g)
    assert exp_g.post_train_graph.counts == {(): [1, 1, 3]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODEL_OPTIONS))
def test_replayed_tick_with_a_trainer_call_never_synchronises_per_model_option(cuda, name):
    """A toy tick with a trainer call under each CVAE option, replaying its
    tick graph, under ``torch.cuda.set_sync_debug_mode("error")``."""
    exp = Experiment(ExperimentConfig(**{**SYNC_TOY, **MODEL_OPTIONS[name]}),
                     train_calls_per_tick=1, train_every=3, device="cuda")
    parts = trained_tick(exp, exp.init(seed=0))
    assert exp.tick_graph.captures >= 2
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        for _, call in parts:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

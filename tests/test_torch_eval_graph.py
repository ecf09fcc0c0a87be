"""The eval runtime's captured steps (``EvalExperiment.tick_graph``, a
``runtime/graphs.py::StepGraph``): the eval tick, the fingerprint capture
step and the identification tick, held on the CPU through ``EagerGraph``.

``EagerGraph`` replays by calling the step's body again on the static
buffers; the body reads the host ints (the eval step, the arm's command
count) as they were at capture, as a CUDA graph freezes them. So a staged
run equals the eager one only if every host branch is a pattern key, the
carry (the eval state with the capture's model state or the
identification's beliefs) is written back into the static buffers each
step, and the outs are cloned. Every comparison with the eager runtime is
bit for bit. The last tests step-match the staged capture and the staged
identification run against the JAX package on fed draws, at the
tolerances of ``test_torch_fp_runtime.py``. The CUDA graphs themselves
are held against the eager steps on the card
(``tests/test_torch_graphs_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ealv_tpu.fingerprint import capture as jcap, identify as jid, test_runtime as jrt
from ealv_tpu_torch.control import ExplrDist
from ealv_tpu_torch.fingerprint import capture as tcap, identify as tid, test_runtime as trt
from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
from ealv_tpu_torch.ops import footprint as tfp, kernels as tkernels
from ealv_tpu_torch.runtime import EvalExperiment, TickDraws
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_fingerprint import close, configs, model_pair
from test_torch_fp_runtime import COMBOS, id_setup, jax_capture_draws, jax_step_by_step, \
    small_beliefs  # noqa: F401
from test_torch_trainer import one_torch_thread  # noqa: F401

TOY = dict(num_target_samples=64, num_traj_samples=50, traj_buffer_capacity=128,
           image_dim=(24, 24, 3), z_dim=8, hidden_dim=(64, 32), cnn_kernels=(3, 3),
           cnn_strides=(2, 2), cnn_channels=(8, 8), compute_dtype="float32")


def _leaves(tree, path="", out=None):
    """[(path, value)] of every tensor and plain value in ``tree``; a
    generator as its state."""
    out = [] if out is None else out
    if isinstance(tree, torch.Generator):
        out.append((path, tree.get_state()))
    elif isinstance(tree, torch.Tensor) or tg._leaf(tree) or isinstance(tree, torch.nn.Module):
        out.append((path, tree))
    else:
        for k, v in tg._fields(tree)[1]:
            _leaves(v, f"{path}.{k}", out)
    return out


def _equal(a, b, what=""):
    """Bit for bit over every leaf (NaN equal to NaN)."""
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.nan_to_num(), y.nan_to_num()) and \
                torch.equal(x.isnan(), y.isnan()), f"{what}{path}"
        elif not isinstance(x, torch.nn.Module):
            assert x == y, f"{what}{path}"


def _staged(ev_exp, graph_type=tg.EagerGraph):
    ev_exp.tick_graph = tg.StepGraph(graph_type)
    return ev_exp


@pytest.fixture
def staged_runtimes(monkeypatch):
    """Every EvalExperiment made in the test gets a staged step graph (the
    ones inside capture_fingerprint and the runtimes too); returns them."""
    made = []
    init = EvalExperiment.__init__

    def staged_init(self, *a, **k):
        init(self, *a, **k)
        made.append(_staged(self))

    monkeypatch.setattr(EvalExperiment, "__init__", staged_init)
    return made


def _fed(ev, cfg, k, rng):
    """Valid fed draws for eval tick ``k`` (its ring not yet wrapped):
    samples in the planner's limits, history indices with the filled
    slots first."""
    lims = ev.pstate.lims.numpy()
    hist = np.concatenate([rng.permutation(k + 1),
                           k + 1 + rng.permutation(cfg.traj_buffer_capacity - k - 1)])
    return TickDraws(samples=torch.tensor(rng.uniform(lims[:, 0], lims[:, 1], (
        cfg.num_target_samples, lims.shape[0])), dtype=torch.float32),
                     hist_idx=torch.tensor(hist[: cfg.num_traj_samples]))


def _target(kind, d, seed=3):
    """(pdf_fn, ctx): an ExplrDist mixture of three pushes, or a frozen
    CVAE seeded with one random sample (its uncertainty as the pdf)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    if kind == "explr":
        dist = ExplrDist.create(8, d, device="cpu")
        for _ in range(3):
            dist = dist.push(t(rng.uniform(-0.6, 0.6, d)), t(rng.uniform(0.02, 0.08, d)))
        return (lambda ctx, s: ctx.pdf(s)), dist
    model = CVAE(img_dim=TOY["image_dim"], z_dim=8, s_dim=d, hidden_dim=(64, 32),
                 cnn_kernels=(3, 3), cnn_strides=(2, 2), cnn_channels=(8, 8))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    ms, _ = update_dist(model, init_model_state(model, "cpu"), t(rng.uniform(-1, 1, d)),
                        t(rng.uniform(0, 1, TOY["image_dim"])))
    return (lambda ctx, s: ctx[0].pdf(ctx[1], s)), (model, ms)


EVAL_PATHS = {"xyw-cvae": dict(states="xyw", target="cvae"),
              "xyzrpw-explr": dict(states="xyzrpw", target="explr"),
              "arm-drift": dict(states="xyw", target="explr", sim_backend="arm", drift_every=2)}


def _eval_pair(states, target, drift_every=None, **kw):
    cfg = ExperimentConfig(**{**TOY, "states": states, **kw})
    out = []
    for staged in (False, True):
        fn, ctx = _target(target, cfg.s_dim)
        ev_exp = EvalExperiment(cfg, fn, device="cpu")
        if drift_every is not None:
            ev_exp.env = dataclasses.replace(ev_exp.env, drift_every=drift_every)
        if staged:
            _staged(ev_exp)
        out.append((ev_exp, ctx, ev_exp.init(seed=2)))
    return cfg, out


@pytest.mark.parametrize("fed", [False, True], ids=["generator", "fed"])
@pytest.mark.parametrize("path", list(EVAL_PATHS))
def test_staged_eval_ticks_equal_eager_ticks(path, fed):
    """Seven eval ticks (on the arm a drift correction every second
    command, so the drift key flips every tick) through the staged tick
    graph against the eager ticks, on the planner's generator or on fed
    draws: every tick's observation (compared after the last tick) and the
    eval state after every tick, the generator's state included. Each
    pattern's first tick runs eagerly, its second captures, later ones
    replay."""
    cfg, runs = _eval_pair(**EVAL_PATHS[path])
    rng = np.random.default_rng(4)
    states = [ev for _, _, ev in runs]
    obs = ([], [])
    for k in range(7):
        draws = _fed(states[0], cfg, k, rng) if fed else None
        for i, (ev_exp, ctx, _) in enumerate(runs):
            states[i], o = ev_exp.tick(states[i], ctx, draws)
            obs[i].append(o)
        _equal(states[0], states[1], f"tick {k}")
    for k, (a, b) in enumerate(zip(*obs)):
        _equal(a, b, f"obs {k}")
    g = runs[1][0].tick_graph
    if path == "arm-drift":
        assert {p[-1] for p in g.counts} == {(True,), (False,)}
        assert states[1].env.count == states[0].env.count == 7
        assert (g.warmups, g.captures, g.replays) == (2, 2, 5)
    else:
        assert g.counts == {("tick", ()): [1, 1, 6]}
    assert states[1].step == 7


def test_a_new_target_drops_the_graphs():
    """The target context is read in place: a new ExplrDist (other
    addresses) drops the captured graphs, and its first tick runs
    eagerly; the run still equals the eager one."""
    cfg, runs = _eval_pair("xyw", "explr")
    states = [ev for _, _, ev in runs]
    for k in range(6):
        for i, (ev_exp, ctx, _) in enumerate(runs):
            if k == 3:
                ctx = ctx.push(torch.tensor([0.1, 0.2, 0.3]), torch.tensor([0.05] * 3))
                runs[i] = (ev_exp, ctx, None)
            states[i], _ = ev_exp.tick(states[i], ctx)
        _equal(states[0], states[1], f"tick {k}")
    assert runs[1][0].tick_graph.counts == {("tick", ()): [2, 2, 4]}


def _capture_runs(drift_every=None, fed=False, n=6, **kw):
    """``n`` capture steps from one centre, eager and staged (``kw`` the
    config's): [(outs per step, final eval state, final model state, the
    step graph)]."""
    jc, tc = configs(**kw)
    model = model_pair(jc)[2]
    center = np.array([0.2, -0.3, 0.1], np.float32)
    out = []
    for staged in (False, True):
        ev_exp, target, ev, ms = tcap.capture_start(model, tc, center, seed=1, device="cpu")
        if drift_every is not None:
            ev_exp.env = dataclasses.replace(ev_exp.env, drift_every=drift_every)
        if staged:
            _staged(ev_exp)
        rng = np.random.default_rng(5)
        outs = []
        for i in range(n):
            draws = _fed(ev, tc, i, rng) if fed else None
            ev, ms, o = tcap.capture_step(ev_exp, model, target, ev, ms, draws, first=i == 0)
            outs.append(o)
        out.append((outs, ev, ms, ev_exp.tick_graph))
    return out


@pytest.mark.parametrize("kw", [{}, dict(fed=True), dict(sim_backend="arm", drift_every=2)],
                         ids=["generator", "fed", "arm-drift"])
def test_staged_capture_equals_eager_capture(kw):
    """Six capture steps (the eval tick toward the capture target, then the
    encode) staged against eager: every step's (z_mu, z_logvar, robot
    state) and the first image, the final eval state and model state, bit
    for bit. The first step is a pattern of its own (it returns the
    image); on the arm the drift key splits the others in two."""
    (outs_e, ev_e, ms_e, _), (outs_g, ev_g, ms_g, g) = _capture_runs(**kw)
    _equal(outs_e, outs_g, "outs ")
    _equal(ev_e, ev_g, "eval state ")
    _equal(ms_e, ms_g, "model state ")
    assert len(outs_g[0]) == 4 and all(len(o) == 3 for o in outs_g[1:])
    first = [c for p, c in g.counts.items() if p[1]]
    rest = {p[2]: c for p, c in g.counts.items() if not p[1]}
    assert first == [[1, 0, 0]]
    if "drift_every" in kw:
        assert rest == {(True,): [1, 1, 2], (False,): [1, 1, 1]}
    else:
        assert rest == {(): [1, 1, 4]}


def test_staged_capture_fingerprint_equals_eager(staged_runtimes):
    """The public capture_fingerprint through a staged EvalExperiment (one
    made inside the call) equals the eager capture's dict bit for bit."""
    jc, tc = configs()
    model = model_pair(jc)[2]
    center = np.array([0.1, 0.2, 0.0], np.float32)
    got = tcap.capture_fingerprint(model, tc, center, num_steps=5, min_pose_dist=0.0, seed=3,
                                   device="cpu")
    assert len(staged_runtimes) == 1 and staged_runtimes[0].tick_graph.replays == 3
    # the eager capture: a fresh EvalExperiment whose graph is set to None
    ev_exp, target, ev, ms = tcap.capture_start(model, tc, center, seed=3, device="cpu")
    ev_exp.tick_graph = None
    outs = []
    for i in range(5):
        ev, ms, o = tcap.capture_step(ev_exp, model, target, ev, ms, first=i == 0)
        outs.append(o)
    want = tcap.finish_capture([o[:3] for o in outs], outs[0][3], center, 0.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _runtimes(id_setup, kind, seek_mode="fixed", adopt=2):
    """The eager and the staged runtime of one kind ("test": KL alone;
    "matrix": the four combinations) from the same small beliefs."""
    jc, tc, jm, jp, tm, jfs, tfs = id_setup
    out = []
    for staged in (False, True):
        if kind == "test":
            rt = trt.FingerprintTestRuntime(
                tc, tm, tfs, dist_method="KL", update_tdist_step=adopt, device="cpu",
                beliefs=small_beliefs(tid, tc, tfs, (("KL", False),), device="cpu")["KL"])
        else:
            rt = trt.FingerprintMatrixRuntime(
                tc, tm, tfs, combos=COMBOS, seek_mode=seek_mode, update_tdist_step=adopt,
                device="cpu", beliefs=small_beliefs(tid, tc, tfs, COMBOS, device="cpu"))
        if staged:
            _staged(rt._ev)
        out.append(rt)
    return out


def _storages(tree) -> set:
    return {v.untyped_storage().data_ptr() for _, v in _leaves(tree)
            if isinstance(v, torch.Tensor) and v.numel()}


@pytest.mark.parametrize("update_every", [1, 2])
@pytest.mark.parametrize("kind,seek_mode", [("test", "fixed"), ("matrix", "fixed"),
                                            ("matrix", "uncertain")])
def test_staged_identification_run_equals_eager(id_setup, kind, seek_mode, update_every):
    """Eight identification ticks with adoption at step 2 (so the
    adoption switch and, with ``update_every`` 2, the update skip key two
    to four patterns) staged against eager: the history (distances, robot
    states, adopted objects), the returned beliefs bit for bit. The
    returned beliefs share no memory with the graph's static carry, and a
    second run leaves them as they were."""
    rt_e, rt_g = _runtimes(id_setup, kind, seek_mode)
    (b_e, h_e), (b_g, h_g) = (rt.run(8, seed=3, update_every=update_every)
                              for rt in (rt_e, rt_g))
    assert len(h_e) == len(h_g) == 8 // update_every
    for a, b in zip(h_e, h_g):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    _equal(b_e, b_g, "beliefs ")
    if kind == "matrix":
        np.testing.assert_array_equal(rt_e.seek_history, rt_g.seek_history)
    g = rt_g._ev.tick_graph
    assert len(g.counts) == 2 * update_every and g.replays >= 8 - 4 * update_every
    assert not _storages(b_g) & _storages(g.carry)
    # the matrix runtime returns its beliefs dict, which a second run
    # updates: hold the belief objects the first run returned
    returned = {k: list(v) for k, v in b_g.items()} if kind == "matrix" else list(b_g)
    kept = tg._clone(returned)
    rt_g.run(3, seed=4, update_every=update_every)
    _equal(kept, returned, "first run's beliefs after a second run ")


class _FailingGraph(tg.EagerGraph):
    def capture(self, body, static):
        tfp.footprint_and_spread.launches += 12  # as the wrapper would while recording
        raise RuntimeError("operation not permitted when stream is capturing")


def test_failed_eval_capture_raises_every_time():
    """A step whose capture fails raises on that tick and on every later
    tick of its pattern; the eager tick never takes its place, and the
    wrappers' counts are set back."""
    cfg, runs = _eval_pair("xyw", "explr")
    ev_exp, ctx, ev = runs[1]
    ev_exp.tick_graph = tg.StepGraph(_FailingGraph)
    ev, _ = ev_exp.tick(ev, ctx)
    before = tg.kernel_counts()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            ev_exp.tick(ev, ctx)
    assert tg.kernel_counts() == before and ev.step == 1
    assert (ev_exp.tick_graph.warmups, ev_exp.tick_graph.captures) == (1, 0)


class _RecordingGraph(tg.EagerGraph):
    """Records a step's launches as a CUDA capture does: the capture runs
    the body once on a copy of the static inputs (fed draws, so no
    generator moves), and a replay leaves the wrappers' counts as they
    were."""

    def capture(self, body, static):
        super().capture(body, static)
        body(tg._clone(static))

    def replay(self):
        before = tg.kernel_counts()
        out = super().replay()
        for name, fn in tg.KERNELS.items():
            fn.launches = before[name]
        return out


@pytest.fixture
def counted_k1(monkeypatch):
    """K1's wrapper count moves on the CPU too: one a call of the plain
    version, as on the card one a launch."""
    plain = tkernels.footprint_and_spread

    def counted(*a, **k):
        tfp.footprint_and_spread.launches += 1
        return plain(*a, **k)

    monkeypatch.setattr(tkernels, "footprint_and_spread", counted)
    tg.reset_launches()
    yield
    tg.reset_launches()


def test_k1_launches_counted_through_the_replays(id_setup, counted_k1):
    """12 K1 launches a tick, read through the replays
    (``graphs.total_launches``: the wrappers' eager counts plus what every
    graph's replays launched): eval ticks, capture steps and
    identification ticks, each run's first step its only eager one."""
    cfg, runs = _eval_pair("xyw", "explr")
    ev_exp, ctx, ev = runs[1]
    ev_exp.tick_graph = tg.StepGraph(_RecordingGraph)
    rng = np.random.default_rng(6)
    for k in range(4):
        ev, _ = ev_exp.tick(ev, ctx, _fed(ev, cfg, k, rng))
    assert tg.total_launches()["footprint_and_spread"] == 48
    assert tg.kernel_counts()["footprint_and_spread"] == 12  # the eager first tick
    assert ev_exp.tick_graph.launched["footprint_and_spread"] == 36

    tg.reset_launches()
    jc, tc = configs()
    model = model_pair(jc)[2]
    cap, target, ev, ms = tcap.capture_start(model, tc, np.zeros(3, np.float32), device="cpu")
    cap.tick_graph = tg.StepGraph(_RecordingGraph)
    for k in range(4):
        ev, ms, _ = tcap.capture_step(cap, model, target, ev, ms, _fed(ev, tc, k, rng),
                                      first=k == 0)
    assert tg.total_launches()["footprint_and_spread"] == 48
    assert cap.tick_graph.replays == 2  # the first step and the second are eager

    tg.reset_launches()
    _, rt = _runtimes(id_setup, "matrix", "uncertain", adopt=0)
    rt._ev.tick_graph = tg.StepGraph(_RecordingGraph)
    beliefs = [list(rt.beliefs[rt.combo_key(m, e)]) for m, e in COMBOS]
    ev = rt._ev.init(seed=1)
    lims = torch.tensor(tc.robot_lim), torch.tensor(tc.tray_lim)
    for k in range(4):
        ev, *_ = trt._identification_tick(rt._ev, rt.model, rt.fps, tc, COMBOS, beliefs, 0, 0,
                                          0, 1, ev, *lims, "uncertain", _fed(ev, tc, k, rng))
    assert tg.total_launches()["footprint_and_spread"] == 48
    assert rt._ev.tick_graph.replays == 3


def test_staged_capture_step_matched_with_jax(staged_runtimes):
    """The staged capture_fingerprint on the JAX capture's draws against
    the JAX ``capture_fingerprint`` (one scan of tick and encode): the
    latents and poses at 1e-4, ``center_img`` at 1e-5 (the tolerances of
    ``test_torch_fp_runtime.py``); the capture replays."""
    jc, tc = configs()
    jm, jp, tm = model_pair(jc)
    center = np.array([0.2, -0.3, 0.0], np.float32)
    draws = jax_capture_draws(jc, center, None, 4, seed=1)
    want = jcap.capture_fingerprint(jm, jp, jc, center, num_steps=4, seed=1)
    got = tcap.capture_fingerprint(tm, tc, center, num_steps=4, seed=1, draws=draws,
                                   device="cpu")
    for key in ("z_mu", "z_var", "x"):
        assert got[key].shape == want[key].shape, key
        close(got[key], want[key], 1e-4, key)
    close(got["center_img"], want["center_img"], 1e-5, "center_img")
    assert staged_runtimes[0].tick_graph.replays == 2


def test_staged_identification_run_step_matched_with_jax(id_setup):
    """The staged matrix runtime (uncertain seek mode, adoption at step 2,
    an update every second step: four patterns) on the JAX keys' draws
    against the JAX runtime's fused run (``_fused_run_program``, one scan
    with the adoption switch on the device): every step's robot state,
    every combination's distances (NaN on the skipped steps) and adopted
    object, and the final beliefs, at 1e-4."""
    jc, tc, jm, jp, tm, jfs, tfs = id_setup
    kw = dict(combos=COMBOS, seek_mode="uncertain", update_tdist_step=2)
    rt_j = jrt.FingerprintMatrixRuntime(jc, jm, jp, jfs, beliefs=small_beliefs(
        jid, jc, jfs, COMBOS), **kw)
    rt_t = trt.FingerprintMatrixRuntime(tc, tm, tfs, device="cpu", beliefs=small_beliefs(
        tid, tc, tfs, COMBOS, device="cpu"), **kw)
    _staged(rt_t._ev)
    draws = jax_step_by_step(rt_j, 6, 4, 2)[4]
    beliefs_j, hist_j = rt_j.run(6, seed=4, update_every=2)
    beliefs_t, hist_t = rt_t.run(6, seed=4, update_every=2, draws=draws)
    assert [h["step"] for h in hist_t] == [h["step"] for h in hist_j] == [0, 2, 4]
    for a, b in zip(hist_t, hist_j):
        assert a["seek_k"] == b["seek_k"]
        close(a["robot_state"], b["robot_state"], 1e-4, f"step {a['step']} robot state")
        for key in beliefs_t:
            close(a[key], b[key], 1e-4, f"step {a['step']} {key}", rtol=1e-4)
    for key in beliefs_t:
        for tb, jb in zip(beliefs_t[key], beliefs_j[key]):
            close(tb.prior, jb.prior, 1e-4, f"{key} prior")
            close(tb.prior_var, jb.prior_var, 1e-4, f"{key} prior_var", rtol=1e-4)
            assert int(tb.count) == int(jb.count)
    np.testing.assert_array_equal(rt_t.seek_history, rt_j.seek_history)
    g = rt_t._ev.tick_graph
    assert len(g.counts) == 4 and g.replays == 2

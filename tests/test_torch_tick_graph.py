"""The whole tick and the post-training call as captured steps
(``runtime/graphs.py::StepGraph``, ``Experiment.tick_graph`` and
``post_train_graph``), held on the CPU through ``EagerGraph``.

``EagerGraph`` replays by calling the step's body again on the static
buffers, and the body reads the host ints (``explr_step``,
``learning_ind``, the optimizer iterations, the arm's command count) as
they were when the pattern was captured, as a CUDA graph freezes them. So
a staged chunk equals the eager ticks only if every host value the tick
computes with is staged, the carry is written back into the static buffers
each step, and the infos are cloned out. Every comparison with the eager
experiment is bit for bit (the same arithmetic on the same inputs). The
last tests step-match the staged chunk and post-training calls against
the JAX package on fed draws, at the tolerances of ``test_torch_tick.py``
and ``test_torch_post_train.py``. The CUDA graphs themselves are held
against the eager ticks on the card (``tests/test_torch_graphs_cuda.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.ops import footprint as tfp
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import experiment_state_from_jax, params_from_jax
from test_torch_checkpoint import assert_states_equal
from test_torch_post_train import _experiments as post_train_experiments, _jax_call_draws
from test_torch_tick import TOY as TICK_TOY, _close, _jax_tick_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

# the port's checkpoint tests' toy experiment
TOY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
           cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
           num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
           batch_size=8, num_learning_opt=2)
VARIANT = dict(states="xywb", learn_force=True, use_z_ensemble=True,
               fast_encoder_grads="pallas")


def _experiment(staged, calls=1, drift_every=None, fused_adam=False, **kw):
    """A toy CPU Experiment (a trainer call every third tick); ``staged``
    runs its ticks and post-training calls through ``StepGraph``s over
    ``EagerGraph``."""
    exp = Experiment(ExperimentConfig(**{**TOY, **kw}), train_calls_per_tick=calls,
                     train_every=3, device="cpu")
    exp.trainer = dataclasses.replace(exp.trainer, fused_adam=fused_adam)
    if drift_every is not None:
        exp.env = dataclasses.replace(exp.env, drift_every=drift_every)
    if staged:
        exp.tick_graph = tg.StepGraph(tg.EagerGraph)
        exp.post_train_graph = tg.StepGraph(tg.EagerGraph)
    return exp


def _host_ints(es):
    return (es.explr_step, es.learning_ind, es.hyper.iter, getattr(es.env, "count", None))


def _chunks_equal(n, post=0, per_tick=None, **kw):
    """``n`` ticks through run_chunk (then ``post`` post-training calls) on
    an eager and a staged experiment from seed 0: every tick's info, the
    final state and the host ints bit for bit. The infos are compared after
    the last tick, so an info not cloned out of the graph's buffers would
    show a later tick's value. ``per_tick(es_eager, es_staged)`` is checked
    after every tick. Returns the staged experiment."""
    runs = [_experiment(staged, **kw) for staged in (False, True)]
    runs = [(exp, exp.init(seed=0)) for exp in runs]
    if per_tick is None:
        infos = [[exp.run_chunk(es, n)[1]] for exp, es in runs]
    else:  # tick by tick, the infos as the ticks return them
        infos = [[], []]
        for _ in range(n):
            for (exp, es), out in zip(runs, infos):
                out.append(exp.tick(es)[1])
            per_tick(runs[0][1], runs[1][1])
    for i, (a, b) in enumerate(zip(*infos)):
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    if post:
        rows = [exp.post_train_chunk(es, post)[1] for exp, es in runs]
        for k in rows[0]:
            assert torch.equal(rows[0][k], rows[1][k]), k
    assert_states_equal(runs[0][1], runs[1][1])
    assert _host_ints(runs[0][1]) == _host_ints(runs[1][1])
    return runs[1][0]


@pytest.mark.parametrize("states", ["xyw", "xyzrpw"])
@pytest.mark.parametrize("calls", [1, 3])
def test_run_chunk_through_the_tick_graph_equals_eager_ticks(states, calls):
    """Twelve ticks with a trainer call (or three) every third tick and the
    prior's target for the first five: four patterns of (trainer calls,
    prior, drift). Each pattern's first tick runs eagerly, its second
    captures and replays, later ones replay; the first trainer call makes
    the optimizer's moments, which the graphs read in place, so the
    pattern captured before it runs eagerly once more."""
    exp = _chunks_equal(12, states=states, calls=calls, prior_steps=5)
    t, u = (True,) * calls, (False,) * calls
    g = exp.tick_graph
    # ticks 0-2, 4: (u, prior); 3: (t, prior); 5, 7, 8, 10, 11: (u, no prior);
    # 6, 9: (t, no prior). Tick 3 makes the moments: tick 4 is eager again.
    assert g.counts == {(u, True, ()): [2, 1, 2], (t, True, ()): [1, 0, 0],
                        (u, False, ()): [1, 1, 4], (t, False, ()): [1, 1, 1]}
    assert (g.warmups, g.captures, g.replays) == (5, 3, 7)


def test_a_patterns_first_tick_after_a_replay_returns_its_own_info():
    """Sixteen ticks, the prior's target for the first eight: tick 8, the
    first without the prior, runs eagerly right after a replay, so the
    carry it starts from is the graphs' static buffers; its info (beta and
    gamma unchanged) must not be those buffers, which the trainer ticks'
    replays overwrite later."""
    exp = _chunks_equal(16, prior_steps=8)
    assert exp.tick_graph.counts[((False,), False, ())][0] == 1


@pytest.mark.parametrize("kw", [dict(VARIANT, fused_adam=True),
                                dict(explr_method="randomWalk", states="xywb"),
                                dict(explr_method="uniform")],
                         ids=["xywb-force-ensemble-K2-K3", "randomWalk", "uniform"])
def test_variant_and_baseline_chunks_through_the_tick_graph(kw):
    """The experiment's options together (the brightness state, the force
    variant, the z-ensemble, K2 and K3's plain versions) and the baseline
    explorers, nine ticks and three post-training calls."""
    exp = _chunks_equal(9, post=3, **kw)
    assert exp.tick_graph.replays >= 3 and exp.post_train_graph.replays == 2


def test_arm_chunk_through_the_tick_graph_flips_the_drift_key():
    """The arm with a drift correction every second command: the drift
    pattern flips every tick, and with the throttle there are four
    patterns, each eager on its first tick."""
    exp = _chunks_equal(14, sim_backend="arm", drift_every=2)
    patterns = exp.tick_graph.counts
    assert {p[2] for p in patterns} == {(True,), (False,)}
    assert len(patterns) == 4 and exp.tick_graph.replays >= 4


def test_arm_drift_twins_are_captured_ahead_and_replay_on_their_first_tick():
    """The arm with a drift correction every tenth command (ticks 9 and
    19, a trainer tick and an exploration tick): each tick that captures
    also captures its pattern's drift-correcting twin, so neither
    correction runs eagerly or captures in its own tick, and the twenty
    ticks equal the eager ones bit for bit."""
    runs = [_experiment(staged, sim_backend="arm", drift_every=10) for staged in (False, True)]
    g = runs[1].tick_graph
    runs = [(exp, exp.init(seed=0)) for exp in runs]
    made, infos = [], [[], []]  # made: (warm-ups, captures) after each tick
    for _ in range(20):
        for (exp, es), out in zip(runs, infos):
            out.append(exp.tick(es)[1])
        made.append((g.warmups, g.captures))
    for i, (a, b) in enumerate(zip(*infos)):
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    assert_states_equal(runs[0][1], runs[1][1])
    assert _host_ints(runs[0][1]) == _host_ints(runs[1][1])
    t, u = (True,), (False,)
    for calls in (t, u):
        warmups, _, replays = g.counts[(calls, False, (True,))]
        assert warmups == 0 and replays == 1, calls
    for step in (9, 19):
        assert made[step] == made[step - 1], step


def test_the_ring_records_each_ticks_step():
    """The hyperparameter ring's explr_ind after every tick equals the
    eager tick's: it is the tick's step, staged into a device scalar (a
    capture of the host int would record the capture tick's step on every
    replay)."""
    seen = []

    def check(es_e, es_g):
        assert int(es_g.buf.explr_ind) == int(es_e.buf.explr_ind)
        seen.append(int(es_e.buf.explr_ind))

    _chunks_equal(13, per_tick=check)
    assert seen[-1] == 12 and len(set(seen)) > 3


def test_manual_ramps_move_on_every_trainer_call():
    """beta and gamma on manual ramps (one ramp step per optimizer
    iteration here, so each trainer call moves them): the staged values
    follow the eager ones call by call, in the ticks and in post-training."""
    seen = []

    def check(es_e, es_g):
        assert torch.equal(es_e.hyper.beta, es_g.hyper.beta)
        assert torch.equal(es_e.hyper.gamma, es_g.hyper.gamma)
        seen.append(float(es_e.hyper.beta))

    ramps = dict(beta_manual_ramp=True, gamma_manual_ramp=True, beta_warmup_epoch=1,
                 gamma_warmup_epoch=1, beta_warmup_steps=100, gamma_warmup_steps=100)
    exp = _chunks_equal(13, post=3, per_tick=check, calls=2, **ramps)
    assert len(set(seen)) >= 4  # the ramps moved on the staged calls
    assert exp.post_train_graph.replays == 2


def test_a_loaded_checkpoint_is_picked_up_and_recaptured(tmp_path):
    """A checkpoint saved from the staged run and loaded into both
    experiments between chunks: load_checkpoint rebuilds the model, the
    optimizer's state and the rings, so every tick graph is dropped and the
    patterns run eagerly again; the next chunk equals the eager one."""
    runs = [_experiment(staged) for staged in (False, True)]
    runs = [[exp, exp.init(seed=0)] for exp in runs]
    for exp, es in runs:
        exp.run_chunk(es, 8)
    g = runs[1][0].tick_graph
    before = (g.warmups, g.captures)
    ck = save_checkpoint(str(tmp_path / "c"), runs[1][1])
    for run in runs:
        run[1] = load_checkpoint(ck, run[0].init(seed=0))
    infos = [exp.run_chunk(es, 7)[1] for exp, es in runs]
    for k in infos[0]:
        assert torch.equal(infos[0][k], infos[1][k]), k
    assert_states_equal(runs[0][1], runs[1][1])
    assert g.warmups >= before[0] + 2 and g.captures >= before[1] + 2


def test_a_swapped_in_jax_state_is_picked_up():
    """A JAX experiment's state after 5 ticks, converted with
    ``experiment_state_from_jax`` and swapped into both experiments after
    each ran its own chunk: the next chunk (own draws) equals the eager
    one."""
    cfg = dict(TICK_TOY, compute_dtype="float32")
    exp_j = JExperiment(JConfig(**cfg), train_calls_per_tick=1, train_every=3)
    es_j, _ = jax.jit(lambda s: exp_j.run_chunk(s, 5))(exp_j.init(seed=0))
    runs = []
    for staged in (False, True):
        exp = Experiment(ExperimentConfig(**cfg), train_calls_per_tick=1, train_every=3,
                         device="cpu")
        if staged:
            exp.tick_graph = tg.StepGraph(tg.EagerGraph)
        es = exp.init(seed=0)
        exp.run_chunk(es, 4)
        runs.append((exp, experiment_state_from_jax(es_j, exp, seed=3)))
    infos = [exp.run_chunk(es, 7)[1] for exp, es in runs]
    for k in infos[0]:
        assert torch.equal(infos[0][k], infos[1][k]), k
    assert_states_equal(runs[0][1], runs[1][1])
    assert runs[1][1].explr_step == 12 and runs[1][0].tick_graph.replays >= 3


@pytest.mark.parametrize("kernels", [False, True], ids=["stock", "K2-K3"])
def test_post_train_chunk_through_the_graph_equals_eager(kernels):
    """Five post-training calls after six ticks: one pattern, so an eager
    call, a capture and its replay, three replays; the rows and the state
    bit for bit."""
    kw = dict(fused_adam=True, fast_encoder_grads="pallas") if kernels else {}
    exp = _chunks_equal(6, post=5, **kw)
    assert exp.post_train_graph.counts == {(): [1, 1, 4]}


def test_step_graph_staging_leaves_its_own_buffers_and_refuses_overlaps():
    """The staging copies a caller's tensor into its static buffer, leaves
    a tensor that is its buffer (the carry after a replay) and refuses one
    that partly overlaps it; the write-back refuses a new carry of another
    shape, and copies a new value that reads another static buffer before
    the copies overwrite that buffer."""
    buf = torch.arange(6.0)
    static = (buf[:3], buf[3:])
    tg._copy_into(static, (torch.ones(3), static[1]))
    assert buf.tolist() == [1, 1, 1, 3, 4, 5]
    with pytest.raises(ValueError, match="partly overlaps"):
        tg._copy_into(static[0], buf[1:4])
    with pytest.raises(ValueError, match="does not fit"):
        tg._write_back(static, (torch.zeros(3), torch.zeros(2)))
    # the new values swap the two halves: each reads the other's buffer
    tg._write_back(static, (static[1], static[0]))
    assert buf.tolist() == [3, 4, 5, 1, 1, 1]
    with pytest.raises(ValueError, match="partly overlaps"):
        tg._write_back(static, (buf[1:4], static[1]))


class _FailingGraph(tg.EagerGraph):
    def capture(self, body, static):
        tfp.footprint_and_spread.launches += 13  # as the wrapper would while recording
        raise RuntimeError("operation not permitted when stream is capturing")


class _RecordingGraph(tg.EagerGraph):
    def capture(self, body, static):
        super().capture(body, static)
        tfp.footprint_and_spread.launches += 13  # a plan's K1 launches


def test_failed_tick_capture_raises_every_time():
    """A tick whose capture fails raises on that tick and on every later
    tick of its pattern; the eager tick never takes its place, and the
    wrappers' counts are set back."""
    exp = _experiment(True)
    exp.tick_graph = tg.StepGraph(_FailingGraph)
    es = exp.init(seed=0)
    exp.tick(es)
    before = tg.kernel_counts()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            exp.tick(es)
    assert tg.kernel_counts() == before and es.explr_step == 1
    assert (exp.tick_graph.warmups, exp.tick_graph.captures) == (1, 0)


def test_tick_replays_count_the_launches_recorded_at_capture():
    """kernel_launches over exp.graphs() includes the tick graph: each
    replay adds what its pattern's capture recorded (13 K1 launches)."""
    exp = _experiment(True)
    exp.tick_graph = tg.StepGraph(_RecordingGraph)
    assert exp.tick_graph in exp.graphs() and exp.post_train_graph in exp.graphs()
    es = exp.init(seed=0)
    tg.reset_launches(*exp.graphs())
    exp.run_chunk(es, 3)  # eager, capture and its replay, replay
    assert exp.tick_graph.replays == 2
    assert tg.kernel_launches(*exp.graphs())["footprint_and_spread"] == 26


def test_staged_chunk_step_matched_with_jax():
    """The staged run_chunk on the JAX keys' draws (fed through
    ``draws``) against the JAX ``run_chunk`` over six ticks, a trainer call
    on the fourth: env pose, pushed pose and image at 1e-4, ergodic cost at
    rtol 2e-3, beta, gamma and loss at rtol 1e-3 (test_torch_tick.py's
    tolerances); the staged ticks replay."""
    cfg = dict(TICK_TOY, compute_dtype="float32")
    exp_j = JExperiment(JConfig(**cfg), train_calls_per_tick=1, train_every=3)
    exp_t = Experiment(ExperimentConfig(**cfg), train_calls_per_tick=1, train_every=3,
                       device="cpu")
    exp_t.tick_graph = tg.StepGraph(tg.EagerGraph)
    es_j = exp_j.init(seed=0)
    es_t = exp_t.init(seed=0)
    es_t.model.load_state_dict(params_from_jax(es_j.params, es_t.model))
    _, chunk_j = jax.jit(lambda s: exp_j.run_chunk(s, 6))(es_j)
    tick_j = jax.jit(exp_j.tick)
    draws = []
    for _ in range(6):
        es_j2, _ = tick_j(es_j)
        draws.append(_jax_tick_draws(exp_j, es_j, es_j2))
        es_j = es_j2
    es_t, chunk_t = exp_t.run_chunk(es_t, 6, draws=draws)
    for k, (rtol, atol) in dict(ergodic_cost=(2e-3, 0), beta=(1e-3, 1e-6),
                                gamma=(1e-3, 1e-6), loss=(1e-3, 1e-6),
                                robot_state=(1e-4, 1e-4), force=(1e-4, 1e-5)).items():
        _close(chunk_t[k], chunk_j[k], rtol, atol, k)
    _close(es_t.env.pose, es_j.env.pose, 1e-4, 1e-5, "env pose")
    slot = int(es_t.buf.pos) - 1
    _close(es_t.buf.y[slot], es_j.buf.y[slot], 1e-4, 1e-4, "pushed image")
    assert es_t.learning_ind == int(es_j.learning_ind) == 1
    assert float(chunk_t["loss"][3]) != 0.0
    assert exp_t.tick_graph.replays >= 2


def test_staged_post_training_step_matched_with_jax():
    """Three post-training calls through the staged graph (an eager call,
    a capture and its replay, a replay) against JAX post_train_chunk on
    the JAX keys' draws: test_torch_post_train.py's tolerances."""
    exp_j, es_j, exp_t, es_t = post_train_experiments()
    exp_t.post_train_graph = tg.StepGraph(tg.EagerGraph)
    post_j = jax.jit(lambda s: exp_j.post_train_chunk(s, 1))
    draws, infos_j = [], []
    for _ in range(3):
        draws.append(_jax_call_draws(exp_j, es_j))
        es_j, info = post_j(es_j)
        infos_j.append(info)
    es_t, info_t = exp_t.post_train_chunk(es_t, 3, draws)
    for key in ("loss", "beta", "gamma"):
        want = np.concatenate([np.asarray(i[key]) for i in infos_j])
        np.testing.assert_allclose(info_t[key].numpy(), want, rtol=1e-3, atol=1e-7,
                                   err_msg=key)
    assert es_t.learning_ind == int(es_j.learning_ind) == 6
    assert es_t.hyper.iter == int(es_j.hyper.iter) == 6
    np.testing.assert_allclose(es_t.buf.beta.numpy(), np.asarray(es_j.buf.beta), rtol=1e-3)
    assert exp_t.post_train_graph.counts == {(): [1, 1, 2]}

"""What the captured calls rest on, held against the JAX package on the
CPU, and the captured calls' staging.

The replay ring's counters are device tensors, as the reference's are: a
capture would freeze host ints. K2's step count lives on the device and
its plain version advances it as the kernel does. The stock optimizer is
``capturable`` on the card; its arithmetic runs here with the CPU admitted
to torch's device check. Then the staging of ``runtime/graphs.py`` without
a card: ``EagerGraph`` replays by calling the function again on the static
buffers and overwrites its outputs, so consecutive staged calls equal
direct calls only if every changing input is copied in before a replay and
every output cloned out after it. The CUDA graphs themselves are held
against the eager calls on the card (``tests/test_torch_graphs_cuda.py``).
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.optim.adam as torch_adam

from ealv_tpu.data.replay import ReplayBuffer as JRB, TrajMemory as JTM
from ealv_tpu.ops import pallas_adam as jpa
from ealv_tpu_torch.data import replay as treplay
from ealv_tpu_torch.data.replay import ReplayBuffer, TrajMemory
from ealv_tpu_torch.ops import adam as tad
from ealv_tpu_torch.ops import footprint as tfp
from ealv_tpu_torch.runtime import Experiment, TrainDraws, train_call
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_checkpoint import assert_states_equal
from test_torch_trainer import one_torch_thread  # noqa: F401

IMG = (4, 5, 3)
LR = 1e-3
# the port's checkpoint tests' toy experiment
TOY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
           cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
           num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
           batch_size=8, num_learning_opt=2)


def _push_pair(jb, tb, rng):
    x = rng.uniform(-1, 1, 3).astype(np.float32)
    y = rng.uniform(0, 1, IMG).astype(np.float32)
    f = rng.uniform(0, 5, 1).astype(np.float32)
    tb.push(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(f))
    return jb.push(jnp.array(x), jnp.array(y), jnp.array(f))


@pytest.mark.parametrize("cap,n_push,batch", [(6, 13, 4), (7, 23, 5), (8, 3, 6)])
def test_ring_device_counters_through_fill_and_wrap(cap, n_push, batch, monkeypatch):
    """pos, size and total are () int64 tensors written in place, equal to
    the JAX ring's at every push; get_xi, get_last and sample_indices (fed
    the JAX draw's Gumbel noise, weighted and not, a batch past the fill
    included) follow them."""
    rng = np.random.default_rng(cap)
    jb = JRB.create(cap, 3, IMG, beta_capacity=4)
    tb = ReplayBuffer.create(cap, 3, IMG, "cpu", beta_capacity=4)
    counters = (tb.pos, tb.size, tb.total)
    key = jax.random.PRNGKey(cap)
    for i in range(n_push):
        jb = _push_pair(jb, tb, rng)
        assert all(c.dtype == torch.int64 and c.dim() == 0 for c in counters)
        assert (tb.pos, tb.size, tb.total) == counters  # the same tensors
        assert [int(c) for c in counters] == [int(jb.pos), int(jb.size), int(jb.total)]
        np.testing.assert_allclose(tb.get_xi().numpy(), np.asarray(jb.get_xi()), rtol=1e-6)
        for got, want in zip(tb.get_last(), jb.get_last()):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for weighted in (True, False):
            key, sub = jax.random.split(key)
            gumbel = torch.from_numpy(np.array(jax.random.gumbel(sub, (cap,))))
            monkeypatch.setattr(treplay, "_gumbel", lambda n, gen, dev: gumbel)
            np.testing.assert_array_equal(
                tb.sample_indices(batch, weighted=weighted).numpy(),
                np.asarray(jb.sample_indices(sub, batch, weighted=weighted)))


def test_traj_memory_push_writes_in_place():
    """The planner's ring writes its row and counters into the same
    tensors, skipping a NaN measurement, as the JAX ring does."""
    rng = np.random.default_rng(1)
    jm = JTM.create(5, 4)
    tm = TrajMemory.create(5, 4, "cpu")
    kept = (tm.buf, tm.pos, tm.size)
    for i in range(9):
        s = rng.uniform(-1, 1, 4).astype(np.float32)
        skip = i in (2, 6)
        if not skip:
            jm = jm.push(jnp.array(s))
        tm.push(torch.from_numpy(s), skip=torch.tensor(skip))
        assert (tm.buf, tm.pos, tm.size) == kept
        np.testing.assert_array_equal(tm.buf.numpy(), np.asarray(jm.buf))
        assert (int(tm.pos), int(tm.size)) == (int(jm.pos), int(jm.size))


@pytest.mark.parametrize("n,steps", [(128, 4), (640 * 128, 3)])
def test_k2_plain_with_device_count_matches_pallas(n, steps):
    """adam_apply with the step count as an int32 () tensor: each call
    advances it in place, then updates as the Pallas kernel (interpret
    mode) does at that count, from non-zero moments; test_torch_adam's
    tolerance (XLA and torch may round b^t by an ulp)."""
    rng = np.random.default_rng(n)
    p, m, v = (rng.normal(0, 0.1, n).astype(np.float32),
               rng.normal(0, 1e-3, n).astype(np.float32),
               rng.uniform(0, 1e-5, n).astype(np.float32))
    jp, jm, jv = map(jnp.asarray, (p, m, v))
    tp, tm, tv = map(torch.from_numpy, (p.copy(), m.copy(), v.copy()))
    count = torch.zeros((), dtype=torch.int32)
    for step in range(1, steps + 1):
        g = rng.normal(0, 1e-2, n).astype(np.float32)
        jp, jm, jv = jpa.adam_update_flat(jp, jm, jv, jnp.asarray(g), jnp.float32(LR),
                                          jnp.int32(step), interpret=True)
        tad.adam_apply([tp], [tm], [tv], [torch.from_numpy(g)], LR, count)
        assert int(count) == step
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_fused_adam_keeps_its_count_on_the_parameters_device():
    """FusedAdam's count is one int32 () tensor a group, advanced in place
    by every step; a saved count, a tensor or an older checkpoint's host
    int, loads into that same tensor."""
    w = torch.zeros(3, requires_grad=True)
    opt = tad.FusedAdam([w], lr=LR)
    count = opt.param_groups[0]["step"]
    assert count.dtype == torch.int32 and count.device == w.device
    for _ in range(3):
        w.grad = torch.ones(3)
        opt.step()
    assert opt.param_groups[0]["step"] is count and int(count) == 3
    sd = opt.state_dict()
    sd["param_groups"][0]["step"] = 7
    opt.load_state_dict(sd)
    assert opt.param_groups[0]["step"] is count and int(count) == 7


@pytest.mark.parametrize("foreach", [False, True])
def test_capturable_adam_matches_optax(monkeypatch, foreach):
    """The stock optimizer as the card builds it (capturable: bias
    corrections from step counts on the device, in its own order of
    operations) against optax.adam over five steps; torch refuses a
    capturable optimizer on the CPU, so its device check admits the CPU
    here. The formulas place the bias correction differently: rtol 1e-5,
    atol 1e-6, as FusedAdam against torch.optim.Adam."""
    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*supported(*a, **k), "cpu"])
    rng = np.random.default_rng(3)
    shapes = [(64, 33), (64,), (7, 3, 3, 3)]
    init = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    params = [torch.tensor(a, requires_grad=True) for a in init]
    opt = torch.optim.Adam(params, lr=LR, capturable=True, foreach=foreach)
    jparams = [jnp.asarray(a) for a in init]
    tx = optax.adam(LR)
    jstate = tx.init(jparams)
    for _ in range(5):
        grads = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    assert all(float(s["step"]) == 5.0 for s in opt.state.values())
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def _toy(fused_adam=False, fast_encoder_grads=False, prior_steps=0, graphs=False,
         states="xyw"):
    """A toy CPU Experiment; with ``graphs`` its trainer and planner calls
    run through the staging of ``runtime/graphs.py`` (``EagerGraph``)."""
    cfg = ExperimentConfig(**{**TOY, "states": states}, fast_encoder_grads=fast_encoder_grads,
                           prior_steps=prior_steps)
    exp = Experiment(cfg, train_calls_per_tick=1, device="cpu")
    exp.trainer = dataclasses.replace(exp.trainer, fused_adam=fused_adam)
    if graphs:
        exp.trainer_graph = tg.TrainerGraph(tg.EagerGraph)
        exp.planner_graph = tg.PlannerGraph(tg.EagerGraph)
    return exp


def _filled(exp, n=12, seed=2):
    es = exp.init(seed=0)
    rng = np.random.default_rng(seed)
    lim = exp.cfg.robot_lim
    for _ in range(n):
        es.buf.push(torch.tensor(rng.uniform(lim[:, 0], lim[:, 1]), dtype=torch.float32),
                    torch.tensor(rng.uniform(0, 1, exp.cfg.image_dim), dtype=torch.float32))
    return es


def _draws(cfg, n, rng):
    steps, B = cfg.num_learning_opt, cfg.batch_size
    return TrainDraws(idx=torch.tensor(rng.integers(0, n, (steps, B))),
                      idx2=torch.tensor(rng.integers(0, n, (steps, B))),
                      eps=torch.tensor(rng.standard_normal((steps, B, cfg.z_dim)),
                                       dtype=torch.float32))


@pytest.mark.parametrize("fed", [True, False])
@pytest.mark.parametrize("kernels", [False, True])
def test_trainer_staging_equals_direct_calls(fed, kernels):
    """Three calls with other beta, gamma and draws each: the direct
    calls, and a TrainerGraph's (an eager call, a capture and its replay,
    a replay), give the same metrics and leave the same state. The
    metrics are compared after the third call, so a replay that did not
    clone them would show the third call's values."""
    rng = np.random.default_rng(5)
    runs = []
    for staged in (False, True):
        exp = _toy(fused_adam=kernels, fast_encoder_grads="pallas" if kernels else False)
        runs.append((exp, _filled(exp), tg.TrainerGraph(tg.EagerGraph) if staged else None))
    calls = [(torch.tensor(b), torch.tensor(g), _draws(runs[0][0].cfg, 12, rng) if fed else None)
             for b, g in ((0.01, 0.5), (0.02, 0.25), (0.005, 0.125))]
    out = []
    for exp, es, graph in runs:
        train = graph or train_call
        out.append([train(exp.trainer, es.model, es.opt, es.buf, beta, gamma,
                          generator=es.gen, draws=draws) for beta, gamma, draws in calls])
    graph = runs[1][2]
    assert (graph.warmups, graph.captures, graph.replays) == (1, 1, 2)
    for direct, staged in zip(*out):
        assert direct.keys() == staged.keys()
        for k in direct:
            assert torch.equal(direct[k], staged[k]), k
    assert_states_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("states", ["xyw", "xyzrpw"])
def test_tick_staging_equals_eager_ticks(states):
    """Nine ticks, with a trainer call every tick after the first and the
    prior's target for the first four (a change of the planner graph's
    key), through the staged planner and trainer calls against the plain
    Experiment: every tick's info and the final state bit for bit. The
    infos are compared after the last tick, so an output that was not
    cloned out of the graph's buffers would show a later tick's value."""
    runs = [_toy(prior_steps=4, graphs=graphs, states=states) for graphs in (False, True)]
    runs = [(exp, exp.init(seed=0)) for exp in runs]
    infos = [[exp.tick(es)[1] for _ in range(9)] for exp, es in runs]
    for i, (a, b) in enumerate(zip(*infos)):
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k)
    assert_states_equal(runs[0][1], runs[1][1])
    exp, es = runs[1]
    p, t = exp.planner_graph, exp.trainer_graph
    # the planner: eager, capture and replay, two replays under the prior
    # (ticks 0-3); eager, capture and replay, three replays after it
    assert (p.warmups, p.captures, p.replays) == (2, 2, 3 + 4)
    # the trainer: a call on ticks 1-8, the first eager
    assert es.learning_ind == 8 and (t.warmups, t.captures, t.replays) == (1, 1, 7)


def test_load_checkpoint_forces_a_new_capture(tmp_path):
    """load_checkpoint rebuilds the ring's and the optimizer's tensors, so
    the trainer graph's key changes: the next call runs eagerly, the one
    after captures anew; the run still equals the plain one."""
    runs = [_toy(graphs=graphs) for graphs in (False, True)]
    runs = [(exp, exp.init(seed=0)) for exp in runs]
    for exp, es in runs:
        for _ in range(4):
            exp.tick(es)
    graph = runs[1][0].trainer_graph
    assert (graph.warmups, graph.captures) == (1, 1)
    ck = save_checkpoint(str(tmp_path / "c"), runs[1][1])
    exp = runs[1][0]
    es = load_checkpoint(ck, exp.init(seed=0))
    runs[1] = (exp, es)
    for exp, es in runs:
        for _ in range(3):
            exp.tick(es)
    assert (graph.warmups, graph.captures) == (2, 2)
    assert_states_equal(runs[0][1], runs[1][1])


class _FailingGraph(tg.EagerGraph):
    def capture(self, body, static):
        tfp.footprint_and_spread.launches += 5  # as a wrapper would while recording
        raise RuntimeError("operation not permitted when stream is capturing")


def test_failed_capture_raises_every_time():
    """A capture that fails raises on the call that captures and on every
    later call under that key: the eager call never takes its place. The
    wrappers' counts are set back, since a capture runs no kernel."""
    exp = _toy()
    es = _filled(exp)
    graph = tg.TrainerGraph(_FailingGraph)
    beta, gamma = torch.tensor(0.01), torch.tensor(0.5)
    graph(exp.trainer, es.model, es.opt, es.buf, beta, gamma, generator=es.gen)
    before = tg.kernel_counts()
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            graph(exp.trainer, es.model, es.opt, es.buf, beta, gamma, generator=es.gen)
    assert tg.kernel_counts() == before
    assert (graph.warmups, graph.captures, graph.replays) == (1, 0, 0)


class _CaptureContext:
    """``torch.cuda.graph`` without a card: its exit fails as a capture's
    end does after an error inside the capture."""

    def __init__(self, graph, capture_error_mode):
        assert capture_error_mode == "thread_local"

    def __enter__(self):
        return self

    def __exit__(self, kind, *_):
        if kind is not None:
            raise RuntimeError("operation failed due to a previous error during capture")
        return False


class _Cycle:
    """Dead once dropped, but freed only by the cyclic collector."""

    def __init__(self, freed):
        self.me, self.freed = self, freed

    def __del__(self):
        self.freed.append(True)


@pytest.mark.parametrize("fails", [False, True], ids=["ok", "body-raises"])
def test_cuda_graph_capture_collects_first_and_names_the_cause(monkeypatch, fails):
    """CudaGraph.capture collects dead reference cycles before the capture
    (one that holds another graph would otherwise be destroyed by a
    collection inside the capture, which invalidates it) and keeps the
    collector off while the call is recorded, then on again. When the
    call raises, the capture's end reports only an invalidated capture:
    the error raised names the call's own, which is its cause."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", _CaptureContext)
    freed, seen = [], []
    _Cycle(freed)

    def body(static):
        seen.append((list(freed), gc.isenabled()))
        if fails:
            raise ValueError("a blocking copy")
        return static + 1

    graph = tg.CudaGraph([])
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capturing the call failed: ValueError: "
                                               "a blocking copy") as info:
            graph.capture(body, 1)
        assert isinstance(info.value.__cause__, ValueError)
    else:
        graph.capture(body, 1)
        assert graph.out == 2
    assert seen == [([True], False)]
    assert gc.isenabled()


class _RecordingGraph(tg.EagerGraph):
    def capture(self, body, static):
        super().capture(body, static)
        tfp.footprint_and_spread.launches += 13  # a plan's K1 launches


def test_replays_count_the_launches_recorded_at_capture():
    """kernel_launches is the wrappers' eager counts plus, for each graph,
    what its capture recorded times its replays; reset_launches zeroes
    both."""
    exp = _toy(graphs=True)
    exp.planner_graph = tg.PlannerGraph(_RecordingGraph)
    es = exp.init(seed=0)
    tg.reset_launches(*exp.graphs())
    for _ in range(4):
        exp.tick(es)
    g = exp.planner_graph
    assert (g.warmups, g.captures, g.replays) == (1, 1, 3)
    assert g.recorded["footprint_and_spread"] == 13
    assert tfp.footprint_and_spread.launches == 0  # CPU: the plain version
    assert tg.kernel_launches(*exp.graphs())["footprint_and_spread"] == 39
    tg.reset_launches(*exp.graphs())
    assert tg.kernel_launches(*exp.graphs()) == dict.fromkeys(tg.KERNELS, 0)


def test_graph_inputs_must_have_a_staged_form():
    """An input the staging cannot copy raises rather than being frozen."""
    with pytest.raises(TypeError, match="no input of type"):
        tg._spec((torch.zeros(2), object()))

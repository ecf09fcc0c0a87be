"""The port's data parallelism (``ealv_tpu_torch/parallel``) against the JAX
package's ``shard_map`` form on two of the conftest's eight virtual CPU
devices.

The port runs one process per rank: two gloo ranks are spawned on the CPU
twice, once for the trainer and decode checks (a module fixture) and once
for the mesh ticks (``run_ranks``: a FileStore rendezvous, torch on one
thread a rank, a timeout of its own that kills the ranks and fails the
test). The ranks'
functions live in ``test_torch_ranks.py``, which imports no JAX, so a rank
starts in about 3 s. The JAX draws
(global batch indices, one shared noise block of batch / 2 rows, planner
samples) are made here and fed to both sides. f32, TF32 off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from ealv_tpu.data.replay import ReplayBuffer as JRB
from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.cvae import init_model_state as j_init_mstate, update_dist as j_update
from ealv_tpu.parallel import dp_train_call as j_dp_train, make_mesh as j_make_mesh, \
    sharded_pdf as j_sharded_pdf
from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.runtime.trainer import TrainerStatics as JStatics
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.parallel import Mesh, dp_train_call, make_mesh
from ealv_tpu_torch.parallel._launch import run_ranks
from ealv_tpu_torch.runtime import Experiment, train_call
from ealv_tpu_torch.runtime.trainer import TrainerStatics
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_ranks import B, HID, IMG, LR, S, Z, _model, _rank_checks, \
    _rank_mesh_ticks, _ring
from test_torch_tick import TOY, _close, _jax_tick_draws
from test_torch_trainer import _compare_params, jax_train_draws, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RANKS = 2
TIMEOUT = 120.0  # seconds for one spawn of two ranks (about 5 s here)


# ---------------------------------------------------------------- setup


@pytest.fixture(scope="module")
def setup():
    jm = JCVAE(img_dim=IMG, z_dim=Z, s_dim=S, hidden_dim=HID)
    jp = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, S)),
                                   jnp.zeros((1, *IMG)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, (12, S)).astype(np.float32)
    ys = rng.uniform(0, 1, (12, *IMG)).astype(np.float32)
    jb = JRB.create(16, S, IMG)
    for x, y in zip(xs, ys):
        jb = jb.push(jnp.array(x), jnp.array(y))
    state = params_from_jax(jp, CVAE(img_dim=IMG, z_dim=Z, s_dim=S, hidden_dim=HID))
    return jm, jp, jb, xs, ys, state


ADAM_KEY, ADAM_STEPS, ADAM_BETA, ADAM_GAMMA = 9, 2, 0.01, 0.8


@pytest.fixture(scope="module")
def ranks(setup):
    """One spawn of two gloo ranks for the three checks below (a spawn
    costs seconds): the Adam call's fed draws, the SGD step's, and the
    sharded decode's inputs, made here with JAX; returns the ranks' outputs
    and the inputs."""
    jm, jp, jb, xs, ys, state = setup
    adam = jax_train_draws(jm, jp, jb, jax.random.PRNGKey(ADAM_KEY), ADAM_STEPS, B,
                           num_shards=RANKS)
    sgd = jax_train_draws(jm, jp, jb, jax.random.PRNGKey(2), 1, B, weighted=False)
    x = np.array([0.1, -0.2, 0.3], np.float32)
    y = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), IMG))
    samples = np.asarray(jax.random.uniform(jax.random.PRNGKey(4), (64, 3), minval=-1,
                                            maxval=1))
    outs = run_ranks(_rank_checks, RANKS, args=(
        state, xs, ys, (adam, ADAM_BETA, ADAM_GAMMA, ADAM_STEPS, False),
        (sgd, 0.0, 0.0, 1, True), (torch.tensor(x), torch.tensor(y), torch.tensor(samples))),
        timeout=TIMEOUT)
    return outs, dict(adam=adam, sgd=sgd, pdf=(x, y, samples))


def _equal_on_ranks(outs):
    """Every rank ends with the same bits (each applied the same averaged
    gradient)."""
    for other in outs[1:]:
        for k, v in outs[0].items():
            assert torch.equal(v, other[k]), k


# ---------------------------------------------------------------- tests


def test_dp_train_call_matches_jax_two_ranks(setup, ranks):
    """Two Adam steps data-parallel over two ranks against the JAX
    ``dp_train_call`` on a two-device mesh, from one key: the same global
    indices and one shared (4, z) noise block a step on both sides. Metrics
    (each the mean over shards) at rtol 1e-3, atol 1e-5, as the trainer's
    two-step test; parameters at rtol 1e-4, atol 2e-6 where the gradient is
    clear of rounding and within 2 * lr * steps everywhere
    (test_torch_trainer.py says why)."""
    jm, jp, jb, xs, ys, state = setup
    key, beta, gamma, steps = (jax.random.PRNGKey(ADAM_KEY), ADAM_BETA, ADAM_GAMMA,
                               ADAM_STEPS)
    draws = ranks[1]["adam"]
    assert draws.eps.shape == (steps, B // RANKS, Z) and draws.idx.shape == (steps, B)
    statics_j = JStatics(model=jm, batch_size=B, num_learning_opt=steps, lr=LR)
    mesh = j_make_mesh(RANKS)
    jp2, _, jmet = jax.jit(lambda p, o: j_dp_train(statics_j, mesh, p, o, jb, key, beta,
                                                   gamma))(jp, optax.adam(LR).init(jp))

    outs = [o["adam"] for o in ranks[0]]
    _equal_on_ranks([o[1] for o in outs])
    met, params = outs[0]
    for k in ("loss", "rc", "kl", "rc_other", "z_activity", "active_units",
              "active_units_vars"):
        assert met[k].dtype == torch.float32 and met[k].shape == (steps,)
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    i1, i2 = jnp.asarray(draws.idx[0].numpy()), jnp.asarray(draws.idx2[0].numpy())

    def jloss(p):
        from ealv_tpu.models.losses import cvae_loss as j_loss
        out = jm.apply(p, jb.x[i1], jb.y[i1], x_decode=jb.x[i2])
        return j_loss(out, jb.y[i1], y2=jb.y[i2], beta=beta, gamma=gamma,
                      gamma_weight=0.1, other_locs=True)[0]

    tm = _model(params)
    _compare_params(tm, jp2, jax.jit(jax.grad(jloss))(jp), steps=steps)


def test_two_ranks_equal_one_full_batch(setup, ranks):
    """The DDP contract, the port's form of tests/test_parallel.py:65-91: an
    SGD step (lr 0.1, deterministic decode, unweighted draws) averaged over
    two ranks' halves of a batch equals the one-process step on the whole
    batch, at the JAX test's rtol 1e-4, atol 1e-6."""
    jm, jp, jb, xs, ys, state = setup
    draws = ranks[1]["sgd"]
    outs = [o["sgd"] for o in ranks[0]]
    _equal_on_ranks([o[1] for o in outs])
    model = _model(state)
    statics = TrainerStatics(batch_size=B, num_learning_opt=1, lr=LR)
    train_call(statics, model, torch.optim.SGD(model.parameters(), lr=0.1), _ring(xs, ys),
               torch.tensor(0.0), torch.tensor(0.0), deterministic=True, weighted=False,
               draws=draws)
    moved = 0.0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(outs[0][1][k], v, rtol=1e-4, atol=1e-6, msg=k)
        moved = max(moved, float((v - state[k]).abs().max()))
    assert moved > 1e-3  # the step moved the weights


def test_sharded_pdf_matches_local_and_jax(setup, ranks):
    """The decode split over two ranks against the one-process decode (rtol
    1e-5, atol 1e-7: the same rows in smaller batches) and against the JAX
    ``sharded_pdf`` on a two-device mesh (rtol 1e-4, atol 1e-6, the JAX
    test's)."""
    jm, jp, jb, xs, ys, state = setup
    x, y, samples = ranks[1]["pdf"]
    mstate, _ = j_update(jm, jp, j_init_mstate(jm), jnp.asarray(x), jnp.asarray(y))
    want = jax.jit(lambda p, ms, s: j_sharded_pdf(jm, j_make_mesh(RANKS), p, ms, s))(
        jp, mstate, jnp.asarray(samples))
    outs = [o["pdf"] for o in ranks[0]]
    assert torch.equal(outs[0][0], outs[1][0])
    sharded, local = outs[0]
    assert sharded.shape == (64,)
    torch.testing.assert_close(sharded, local, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(sharded.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_two_mesh_ticks_match_jax():
    """Two ticks of ``Experiment(mesh=...)`` on two ranks against the JAX
    ``Experiment(mesh=make_mesh(2))`` from the same weights and the JAX
    keys' draws (the trainer's noise one (4, z) block shared by both
    shards): the sharded planner decode and the data-parallel trainer in
    the tick. Tolerances of tests/test_torch_tick.py's step-matched ticks;
    the ranks end bit-equal."""
    cfg_j = JConfig(**TOY, compute_dtype="float32")
    exp_j = JExperiment(cfg_j, train_calls_per_tick=1, train_every=1,
                        mesh=j_make_mesh(RANKS))
    es_j = exp_j.init(seed=0)
    state = params_from_jax(es_j.params, Experiment(
        ExperimentConfig(**TOY, compute_dtype="float32"), device="cpu").make_model())
    tick_j = jax.jit(exp_j.tick)
    draws, want = [], []
    for _ in range(2):
        es_j2, info_j = tick_j(es_j)
        draws.append(_jax_tick_draws(exp_j, es_j, es_j2, num_shards=RANKS))
        slot = int(es_j2.buf.pos) - 1
        want.append(dict(pose=es_j2.env.pose, x=es_j2.buf.x[slot], y=es_j2.buf.y[slot],
                         u=es_j2.pstate.u, cost=info_j["ergodic_cost"], beta=info_j["beta"],
                         gamma=info_j["gamma"], loss=info_j["loss"],
                         learning_ind=int(es_j2.learning_ind)))
        es_j = es_j2
    outs = run_ranks(_rank_mesh_ticks, RANKS, args=(TOY, state, draws), timeout=TIMEOUT)
    _equal_on_ranks([o[-1]["params"] for o in outs])
    for k, (got, w) in enumerate(zip(outs[0], want)):
        _close(got["pose"], w["pose"], 1e-4, 1e-5, f"tick {k} env pose")
        _close(got["x"], w["x"], 1e-4, 1e-4, f"tick {k} pushed pose")
        _close(got["y"], w["y"], 1e-4, 1e-4, f"tick {k} pushed image")
        _close(got["u"], w["u"], 2e-3, 2e-4, f"tick {k} plan u")
        _close(got["cost"], w["cost"], 2e-3, 0, f"tick {k} cost")
        for key in ("beta", "gamma", "loss"):
            _close(got[key], w[key], 1e-3, 1e-6, f"tick {k} {key}")
        assert got["learning_ind"] == w["learning_ind"] == k
    assert float(outs[0][1]["loss"]) != 0.0  # the second tick trained


def test_guards(tmp_path):
    """The JAX guards: ``dp_train_call`` refuses a batch the mesh size does
    not divide, ``Experiment`` a batch or target-sample count it does not
    divide, ``make_mesh`` more ranks than the group has; and NCCL is never
    asked for CPU tensors."""
    three = Mesh(group=None, rank=0, size=3, device=torch.device("cpu"))
    statics = TrainerStatics(batch_size=B, num_learning_opt=1)
    with pytest.raises(ValueError, match="not divisible by 3"):
        dp_train_call(statics, three, None, None, None, 0.0, 0.0)
    two = dataclasses.replace(three, size=2)
    for kw in (dict(batch_size=9), dict(num_target_samples=63)):
        with pytest.raises(ValueError, match="must divide the mesh size 2"):
            Experiment(ExperimentConfig(**{**TOY, **kw}), device="cpu", mesh=two)
    with pytest.raises(ValueError, match="live on"):
        Experiment(ExperimentConfig(**TOY), device="cpu",
                   mesh=dataclasses.replace(two, device=torch.device("meta")))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="requested 2 ranks"):
            make_mesh(2, device="cpu")
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.axis_name, mesh.group) == (0, 1, "data", None)
    finally:
        dist.destroy_process_group()


def test_world_size_one_is_the_plain_call(setup, tmp_path):
    """At one rank the all-reduce is a copy and the division is by 1: a
    data-parallel call equals the plain ``train_call`` bit for bit on the
    same fed draws (the CPU form of chip_smoke.py's NCCL check)."""
    jm, jp, jb, xs, ys, state = setup
    draws = jax_train_draws(jm, jp, jb, jax.random.PRNGKey(5), 2, B)
    statics = TrainerStatics(batch_size=B, num_learning_opt=2, lr=LR)
    runs = []
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        for dp in (True, False):
            model = _model(state)
            opt = statics.make_optimizer(model)
            args = (model, opt, _ring(xs, ys), torch.tensor(0.01), torch.tensor(0.5))
            met = (dp_train_call(statics, make_mesh(device="cpu"), *args, draws=draws)
                   if dp else train_call(statics, *args, draws=draws))
            runs.append((met, model.state_dict()))
    finally:
        dist.destroy_process_group()
    (met_dp, p_dp), (met, p) = runs
    for k, v in met.items():
        assert torch.equal(met_dp[k], v.float()), k
    for k, v in p.items():
        assert torch.equal(p_dp[k], v), k

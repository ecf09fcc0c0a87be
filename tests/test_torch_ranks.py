"""The ranks' side of the data-parallel tests, and ``run_ranks`` itself.

A spawned rank imports the module of the function it runs; this one imports
torch and the port only, so a rank starts without JAX. The rank functions
build the toy model and ring of ``test_torch_parallel.py`` from what the
test sends them and return CPU tensors.
"""

import time

import pytest
import torch
import torch.distributed as dist

from ealv_tpu_torch.data.replay import ReplayBuffer
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.models.cvae import init_model_state, update_dist
from ealv_tpu_torch.parallel import dp_train_call, make_mesh, sharded_pdf
from ealv_tpu_torch.parallel._launch import run_ranks
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.runtime.trainer import TrainerStatics
from ealv_tpu_torch.utils.config import ExperimentConfig

IMG, S, Z, HID, B, LR = (24, 24, 3), 3, 8, (64, 32), 8, 1e-3


def _ring(xs, ys):
    buf = ReplayBuffer.create(16, S, IMG, "cpu")
    for x, y in zip(xs, ys):
        buf.push(torch.from_numpy(x), torch.from_numpy(y))
    return buf


def _model(state):
    model = CVAE(img_dim=IMG, z_dim=Z, s_dim=S, hidden_dim=HID)
    model.load_state_dict(state)
    return model


def _rank_dp_train(state, xs, ys, draws, beta, gamma, steps, sgd):
    """This rank's data-parallel call: Adam (or SGD at lr 0.1) from
    ``state``; returns the metrics and the parameters."""
    mesh = make_mesh(device="cpu")
    model, buf = _model(state), _ring(xs, ys)
    statics = TrainerStatics(batch_size=B, num_learning_opt=steps, lr=LR)
    opt = (torch.optim.SGD(model.parameters(), lr=0.1) if sgd
           else statics.make_optimizer(model))
    met = dp_train_call(statics, mesh, model, opt, buf, torch.tensor(beta),
                        torch.tensor(gamma), deterministic=sgd, weighted=not sgd,
                        draws=draws)
    return met, {k: v.clone() for k, v in model.state_dict().items()}


def _rank_sharded_pdf(state, x, y, samples):
    mesh = make_mesh(device="cpu")
    model = _model(state)
    mstate, _ = update_dist(model, init_model_state(model, "cpu"), x, y)
    return sharded_pdf(model, mesh, mstate, samples), model.pdf(mstate, samples)


def _rank_checks(state, xs, ys, adam, sgd, pdf):
    """The three checks of test_torch_parallel.py in one spawn: the Adam
    call's and the SGD step's ``_rank_dp_train`` arguments after (state,
    xs, ys), and ``_rank_sharded_pdf``'s after state."""
    return dict(adam=_rank_dp_train(state, xs, ys, *adam),
                sgd=_rank_dp_train(state, xs, ys, *sgd),
                pdf=_rank_sharded_pdf(state, *pdf))


def _rank_mesh_ticks(toy, state, draws):
    """Two ticks of the toy Experiment over the two-rank mesh with fed
    draws; returns what the test compares, per tick."""
    exp = Experiment(ExperimentConfig(**toy, compute_dtype="float32"),
                     train_calls_per_tick=1, train_every=1, device="cpu",
                     mesh=make_mesh(device="cpu"))
    es = exp.init(seed=0)
    es.model.load_state_dict(state)
    out = []
    for d in draws:
        es, info = exp.tick(es, d)
        slot = es.buf.pos - 1
        out.append(dict(pose=es.env.pose.clone(), x=es.buf.x[slot].clone(),
                        y=es.buf.y[slot].clone(), u=es.pstate.u.clone(),
                        cost=info["ergodic_cost"], beta=info["beta"], gamma=info["gamma"],
                        loss=info["loss"], learning_ind=es.learning_ind,
                        params={k: v.clone() for k, v in es.model.state_dict().items()}))
    return out


def _rank_fails(fail_rank):
    if dist.get_rank() == fail_rank:
        raise ValueError("this rank fails")
    return dist.get_rank()


def _rank_hangs():
    """Rank 0 returns; rank 1 never does."""
    if dist.get_rank() == 1:
        time.sleep(3600)
    return dist.get_rank()


def _rank_returns():
    return dist.get_rank()


@pytest.mark.parametrize("run", range(3))
def test_run_ranks_survives_ranks_that_return_at_once(run):
    """Ranks that return as soon as the group is up never close it under a
    peer that is still joining (each run spawns anew)."""
    assert run_ranks(_rank_returns, 2, timeout=60.0) == [0, 1]


def test_run_ranks_returns_in_rank_order():
    """Each rank's value comes back in rank order; a collective sees both."""
    assert run_ranks(_rank_fails, 2, args=(-1,), timeout=60.0) == [0, 1]


def test_run_ranks_reports_a_failed_rank():
    """A rank that raises stops the run, and its traceback is the error."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 of _rank_fails failed.*this rank fails"):
        run_ranks(_rank_fails, 2, args=(1,), timeout=60.0)


def test_run_ranks_kills_a_hung_rank():
    """A rank that never returns fails the run at the timeout (10 s here),
    and no rank outlives it."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 10 s"):
        run_ranks(_rank_hangs, 2, timeout=10.0)
    assert time.monotonic() - t0 < 60.0


def _rank_sub_mesh():
    """Every rank asks for a mesh over the first rank alone."""
    try:
        mesh = make_mesh(1, device="cpu")
    except ValueError as e:
        return str(e)
    t = torch.ones(1)
    dist.all_reduce(t, group=mesh.group)  # over the sub-group only
    return mesh.rank, mesh.size, float(t)


def test_make_mesh_over_the_first_ranks():
    """make_mesh(1) in a group of two: rank 0 gets a one-rank mesh with a
    group of its own (its all-reduce sums one rank), rank 1 is refused."""
    r0, r1 = run_ranks(_rank_sub_mesh, 2, timeout=60.0)
    assert r0 == (0, 1, 1.0)
    assert r1 == "rank 1 is outside the mesh of the first 1 ranks"

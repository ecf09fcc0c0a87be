"""The data-parallel trainer call and the mesh tick as captured steps
(``parallel/train.py::dp_train_call`` inside ``Experiment``'s
post-training and tick graphs over a mesh), held on the CPU through
``EagerGraph`` over a one-rank gloo group made in this process: the
staging, the keys and the write-back with the collectives inside the
step's body. On the card the graphs are built
over an NCCL group only (``tests/test_torch_graphs_cuda.py``,
``chip_smoke.py``); a gloo mesh runs eagerly, and ``Experiment`` says so.
Every comparison is bit for bit.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ealv_tpu_torch.parallel import make_mesh
from ealv_tpu_torch.runtime import Experiment, PostTrainDraws, TrainDraws
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_checkpoint import assert_states_equal
from test_torch_tick_graph import TOY
from test_torch_trainer import one_torch_thread  # noqa: F401


@pytest.fixture
def gloo(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _experiment(mesh, staged=False, **kw):
    exp = Experiment(ExperimentConfig(**{**TOY, **kw}), train_calls_per_tick=1,
                     train_every=3, device="cpu", mesh=mesh)
    if staged:
        exp.tick_graph = tg.StepGraph(tg.EagerGraph)
        exp.post_train_graph = tg.StepGraph(tg.EagerGraph)
    return exp


def _filled(exp, n=12, seed=2):
    es = exp.init(seed=0)
    rng = np.random.default_rng(seed)
    lim, cfg = exp.cfg.robot_lim, exp.cfg
    for _ in range(n):
        es.buf.push(torch.tensor(rng.uniform(lim[:, 0], lim[:, 1]), dtype=torch.float32),
                    torch.tensor(rng.uniform(0, 1, cfg.image_dim), dtype=torch.float32))
    return es


@pytest.mark.parametrize("fed", [False, True], ids=["generator", "fed"])
def test_dp_train_call_through_the_post_training_graph_equals_the_direct_call(gloo, fed):
    """Four post-training calls over a filled ring, each one data-parallel
    trainer call, made directly and through the post-training graph over
    ``EagerGraph`` (an eager call, a capture and its replay, two replays),
    on the generator's draws or fed ones: every call's row and the final
    parameters and optimizer moments bit for bit."""
    runs = [(exp, _filled(exp)) for exp in (_experiment(gloo), _experiment(gloo, True))]
    rng = np.random.default_rng(5)
    cfg = runs[0][0].cfg
    lim = cfg.robot_lim
    for call in range(4):
        draws = None
        if fed:
            shape = (cfg.num_learning_opt, cfg.batch_size)
            draws = [PostTrainDraws(
                samples=torch.tensor(rng.uniform(lim[:, 0], lim[:, 1], (
                    cfg.num_target_samples, cfg.s_dim)), dtype=torch.float32),
                train=TrainDraws(
                    idx=torch.tensor(rng.integers(0, 12, shape)),
                    idx2=torch.tensor(rng.integers(0, 12, shape)),
                    eps=torch.tensor(rng.standard_normal((*shape, cfg.z_dim)),
                                     dtype=torch.float32)))]
        rows = [exp.post_train_chunk(es, 1, draws)[1] for exp, es in runs]
        for k in rows[0]:
            assert torch.equal(rows[0][k], rows[1][k]), (call, k)
    assert runs[1][0].post_train_graph.counts == {(): [1, 1, 3]}
    assert_states_equal(runs[0][1], runs[1][1])


def test_mesh_chunk_through_the_tick_graph_equals_eager_ticks(gloo):
    """Nine ticks and two post-training calls over the one-rank mesh (the
    decode through ``sharded_pdf``, the trainer through ``dp_train_call``,
    their all-reduces inside the step's body), staged through
    ``StepGraph(EagerGraph)``, equal the eager mesh experiment's."""
    exps = [_experiment(gloo), _experiment(gloo, staged=True)]
    runs = [(exp, exp.init(seed=0)) for exp in exps]
    infos = [exp.run_chunk(es, 9)[1] for exp, es in runs]
    post = [exp.post_train_chunk(es, 2)[1] for exp, es in runs]
    for a, b in ((infos[0], infos[1]), (post[0], post[1])):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert_states_equal(runs[0][1], runs[1][1])
    assert exps[1].tick_graph.replays >= 2


def test_a_gloo_mesh_and_the_cpu_run_eagerly(gloo):
    """The experiment builds no graph on the CPU, over a mesh or not, and
    records why (over a gloo mesh on the card: "a gloo mesh", whose
    collectives cannot be captured; ``tests/test_torch_graphs_cuda.py``);
    the runner's step graph follows the experiment's pool."""
    from ealv_tpu_torch.hw.bridge import SyntheticBridge
    from ealv_tpu_torch.runtime import HostLoopRunner

    assert gloo.backend == "gloo"
    for mesh in (gloo, None):
        exp = _experiment(mesh)
        assert exp.eager_reason == "the CPU" and exp.graphs() == [] and exp.graph_pool is None
        es = exp.init(seed=0)
        runner = HostLoopRunner(exp, SyntheticBridge(exp.env, es.env))
        assert runner.step_graph is None and runner.plan_graph is None

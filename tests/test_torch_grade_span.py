"""The tracer's device span ``grade`` (``runtime/agent.py``,
``Experiment._grade_spread``): the entropy grade's fresh decode and
coverage spread before a trainer call that does not fold the planner's
decode. Held on the CPU through ``EagerGraph`` at toy size, where a stamp
takes the host clock.

This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grade_span.py
"""

import pytest
import torch

from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.runtime import graphs as tg
from ealv_tpu_torch.runtime import tracing
from ealv_tpu_torch.utils.config import ExperimentConfig

TOY = dict(states="xyz", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
           cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=64,
           num_traj_samples=50, traj_buffer_capacity=128, buffer_capacity=128,
           batch_size=8, num_learning_opt=2)
TICKS = 10  # trainer calls at ticks 3, 6 and 9; every tick pattern warms, captures and replays
# the grade folds the planner's decode only under hyper_from_planner and
# without the z-ensemble
FOLDS = {"folded": dict(),
         "ensemble": dict(use_z_ensemble=True, learn_force=True, sim_backend="arm-dynamic"),
         "recomputed": dict(hyper_from_planner=False)}


@pytest.fixture(autouse=True)
def tracer_off():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()
    torch.set_num_threads(threads)


def _ticks(fold: str) -> tuple:
    """TICKS toy ticks through an ``EagerGraph`` step graph: (each tick's
    infos, whether each tick made a trainer call)."""
    exp = Experiment(ExperimentConfig(**TOY, **FOLDS[fold]), train_calls_per_tick=1,
                     train_every=3, device="cpu")
    exp.tick_graph = tg.StepGraph(tg.EagerGraph)
    es = exp.init(seed=0)
    infos, trained = [], []
    for _ in range(TICKS):
        before = es.learning_ind
        _, info = exp.tick(es)
        trained.append(es.learning_ind > before)
        infos.append({k: v.clone() for k, v in info.items()})
    return infos, trained


@pytest.mark.parametrize("fold", list(FOLDS))
def test_the_grade_span_opens_once_a_call_that_does_not_fold(fold):
    """Unfolded, each trainer call's ``absorb`` holds one ``grade`` span
    before its ``train``; folded, no tick stamps one."""
    tracing.enable("cpu")
    _, trained = _ticks(fold)
    tr = tracing.read()
    assert sum(trained) == 3
    for t in range(TICKS):
        device = [(i, s) for i, s in enumerate(tr.device) if s.tick == t]
        grade = [s for _, s in device if s.name == "grade"]
        if fold == "folded" or not trained[t]:
            assert grade == []
            continue
        (g,) = grade
        absorb = next(i for i, s in device if s.name == "absorb")
        (train,) = [s for _, s in device if s.name == "train"]
        assert g.parent == absorb and g.start_ns <= g.end_ns <= train.start_ns
    summary = tracing.summary(tr)
    assert summary["device_calls"].get("grade", 0) == (0 if fold == "folded" else 3)


@pytest.mark.parametrize("fold", ["ensemble", "recomputed"])
def test_the_grade_span_changes_no_output(fold):
    """Every tick's infos are bit-equal with the tracer on and off."""
    off, trained_off = _ticks(fold)
    tracing.enable("cpu")
    on, trained_on = _ticks(fold)
    assert trained_off == trained_on
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k

"""The port's device rule: every constructor that takes a ``device``
defaults to the card, and none of them falls back to the CPU when CUDA is
missing. Whether this machine has a card is decided inside each test."""

import dataclasses
import inspect

import pytest
import torch

from ealv_tpu_torch.control.dynamics import (DoubleIntegrator, DoubleIntegratorRoll,
                                             DoubleIntegratorSpeed, SingleIntegrator,
                                             make_dynamics)
from ealv_tpu_torch.control.baselines import BaselineController
from ealv_tpu_torch.control.klerg import KlergPlanner
from ealv_tpu_torch.control.target_dists import ExplrDist, gaussian_dist, prior_dist
from ealv_tpu_torch.runtime import EvalExperiment, Experiment
from ealv_tpu_torch.scripts.collect_test_set import collect
from ealv_tpu_torch.sim.env import SyntheticEnv
from ealv_tpu_torch.sim.renderer import TrayScene
from ealv_tpu_torch.utils.config import ExperimentConfig

TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2)
TRAY6 = ((0.2, 0.8), (-0.3, 0.3), (0.05, 0.5), (-3.5, 3.5), (-0.5, 0.5), (-1.0, 1.0))


@pytest.mark.parametrize("fn", [Experiment.__init__, KlergPlanner.__init__,
                                DoubleIntegrator.__init__, make_dynamics, prior_dist,
                                TrayScene.default, SingleIntegrator.__init__,
                                DoubleIntegratorSpeed.__init__,
                                DoubleIntegratorRoll.__init__, gaussian_dist,
                                ExplrDist.create, BaselineController.__init__,
                                TrayScene.make, EvalExperiment.__init__, collect],
                         ids=lambda f: f.__qualname__)
def test_constructor_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_env_defaults_to_the_card():
    field = {f.name: f for f in dataclasses.fields(SyntheticEnv)}["device"]
    assert field.default == "cuda"
    assert SyntheticEnv(tray_lim=TRAY6).device == "cuda"


# each builds its first tensor on the default device
DEFAULT_BUILDS = {
    "Experiment": lambda: Experiment(ExperimentConfig(**TOY)).explored.pose_sel,
    "make_dynamics": lambda: make_dynamics("xy", dt=0.1).A,
    "make_dynamics roll": lambda: make_dynamics("xyzrpw", dt=0.1).A,
    "prior_dist": lambda: prior_dist("xyw").means,
    "TrayScene.default": lambda: TrayScene.default().obj_xy,
    "SyntheticEnv": lambda: SyntheticEnv(tray_lim=TRAY6)._lims(),
    "TrayScene.make": lambda: TrayScene.make(3).obj_xy,
    "BaselineController": lambda: BaselineController("uniform", 0.2, ((-1, 1),),
                                                     ((-1, 1),)).lims,
    "EvalExperiment": lambda: EvalExperiment(ExperimentConfig(**TOY),
                                             lambda c, s: s[:, 0]).explored.pose_sel,
}


@pytest.mark.parametrize("name", list(DEFAULT_BUILDS))
def test_default_device_is_the_card_or_raises(name):
    """With a card the default lands on it; without one it raises, as torch
    does for a CUDA tensor, and never quietly takes the CPU."""
    if torch.cuda.is_available():
        assert DEFAULT_BUILDS[name]().is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            DEFAULT_BUILDS[name]()


def test_explicit_cpu_runs_on_the_cpu():
    exp = Experiment(ExperimentConfig(**TOY), device="cpu")
    assert exp.device.type == "cpu" and exp.explored.pose_sel.device.type == "cpu"
    assert exp.planner.std.device.type == "cpu"

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
from ealv_tpu_torch.fingerprint import belief, capture, identify, io, test_runtime
from ealv_tpu_torch.hw.bridge import SyntheticBridge
from ealv_tpu_torch.runtime import EvalExperiment, Experiment
from ealv_tpu_torch.scripts.collect_test_set import collect
from ealv_tpu_torch.sim import arm
from ealv_tpu_torch.sim.arm import ArmEnv
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
                                TrayScene.make, EvalExperiment.__init__, collect,
                                belief.FingerprintBelief.create,
                                identify.FingerprintSet.from_lists,
                                capture.make_capture_target, capture.capture_fingerprint,
                                capture.build_fingerprints, io.load_beliefs, arm.home],
                         ids=lambda f: f.__qualname__)
def test_constructor_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cls", [test_runtime.FingerprintTestRuntime,
                                 test_runtime.FingerprintMatrixRuntime],
                         ids=lambda c: c.__name__)
def test_runtime_defaults_to_the_card(cls):
    field = {f.name: f for f in dataclasses.fields(cls)}["device"]
    assert field.default == "cuda"


@pytest.mark.parametrize("name", ["run_fingerprint_matrix", "build_manual_fingerprints",
                                  "capture_fingerprint_belief", "capture_ws"])
def test_fingerprint_cli_defaults_to_the_card(name):
    import importlib
    mod = importlib.import_module(f"ealv_tpu_torch.scripts.{name}")
    required = {"build_manual_fingerprints": ["--config", "c", "--ckpt", "k", "--centers", "0"],
                "capture_fingerprint_belief": ["--beliefs", "b"]}.get(name, [])
    assert mod.build_parser().parse_args(required).device == "cuda"


@pytest.mark.parametrize("name", ["runtime.demo", "scripts.replay_run", "scripts.batch_tests",
                                  "scripts.force_study", "scripts.resume_study"])
def test_study_cli_defaults_to_the_card(name):
    import importlib
    mod = importlib.import_module(f"ealv_tpu_torch.{name}")
    required = {"scripts.replay_run": ["--run", "r"]}.get(name, [])
    assert mod.build_parser().parse_args(required).device == "cuda"


def test_make_mesh_defaults_to_the_card():
    from ealv_tpu_torch.parallel import make_mesh
    assert inspect.signature(make_mesh).parameters["device"].default == "cuda"


@pytest.mark.parametrize("cls", [SyntheticEnv, ArmEnv], ids=lambda c: c.__name__)
def test_env_defaults_to_the_card(cls):
    field = {f.name: f for f in dataclasses.fields(cls)}["device"]
    assert field.default == "cuda"
    assert cls(tray_lim=TRAY6).device == "cuda"


def test_bridge_and_runner_follow_their_env_and_experiment():
    """SyntheticBridge keeps the env state's device and the host loop the
    experiment's: on the CPU when they are on the CPU."""
    from ealv_tpu_torch.runtime import HostLoopRunner
    exp = Experiment(ExperimentConfig(**TOY, sim_backend="arm"), device="cpu")
    es = exp.init(seed=0)
    bridge = SyntheticBridge(exp.env, es.env)
    assert bridge.device.type == "cpu" and es.env.q.device.type == "cpu"
    runner = HostLoopRunner(exp, bridge)
    assert all(t.device.type == "cpu" for t in runner._dev(es.env.pose.numpy(), 1.0))


# each builds its first tensor on the default device
DEFAULT_BUILDS = {
    "Experiment": lambda: Experiment(ExperimentConfig(**TOY)).explored.pose_sel,
    "make_dynamics": lambda: make_dynamics("xy", dt=0.1).A,
    "make_dynamics roll": lambda: make_dynamics("xyzrpw", dt=0.1).A,
    "prior_dist": lambda: prior_dist("xyw").means,
    "TrayScene.default": lambda: TrayScene.default().obj_xy,
    "SyntheticEnv": lambda: SyntheticEnv(tray_lim=TRAY6)._lims(),
    "ArmEnv": lambda: ArmEnv(tray_lim=TRAY6)._lims,
    "arm.home": lambda: arm.home(),
    "SyntheticBridge": lambda: SyntheticBridge(
        ArmEnv(tray_lim=TRAY6, img_hw=(8, 8)),
        ArmEnv(tray_lim=TRAY6, img_hw=(8, 8)).init([0.45, 0.0, 0.3, 3.14, 0.0, 0.0],
                                                   ik_iters=1)).state.pose,
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

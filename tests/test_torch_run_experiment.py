"""The port's run entry point, ``python -m ealv_tpu_torch.scripts.run_experiment``,
at ``--small --device cpu``: the run directory it writes, ``--resume``
picking up the latest checkpoint, and the options it does not port being
rejected. Port only; the run loop is called in-process through ``main``.
"""

import json
import os

import numpy as np
import pytest
import torch

from ealv_tpu_torch.runtime.checkpoint import load_checkpoint
from ealv_tpu_torch.scripts import run_experiment as cli
from test_torch_checkpoint import assert_states_equal
from test_torch_trainer import one_torch_thread  # noqa: F401

SMALL = ["--small", "--device", "cpu", "--chunk", "2"]


def _run_dir(out):
    return os.path.join(out, "synth", "entklerg_0000")


def test_run_writes_its_run_directory(tmp_path):
    """4 steps with a checkpoint every 2, then post-training to 4 * 3 = 12
    trainer calls and the postexplr checkpoint, which holds the final
    state."""
    out = str(tmp_path)
    es = cli.main([*SMALL, "--steps", "4", "--save-rate", "2", "--out", out])
    d = _run_dir(out)
    assert sorted(os.listdir(d)) == ["checkpoints", "config.yaml", "log.txt",
                                     "metrics.npz", "metrics_summary.json"]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "postexplr", "step_0000002", "step_0000004"]
    assert es.explr_step == 4 and es.learning_ind == 12
    m = np.load(os.path.join(d, "metrics.npz"))
    assert m["ergodic_cost"].shape == (4,) and m["loss"].shape == (4 + 12 - 3,)
    assert np.isfinite(m["loss"]).all()
    with open(os.path.join(d, "metrics_summary.json")) as f:
        assert json.load(f)["loss"]["n"] == m["loss"].shape[0]
    log = open(os.path.join(d, "log.txt")).read()
    assert "post-exploration training" in log and "postexplr checkpoint" in log
    args = cli.build_parser().parse_args([*SMALL, "--steps", "4"])
    exp = cli.make_experiment(cli.make_config(args), args)
    restored = load_checkpoint(os.path.join(d, "checkpoints", "postexplr"), exp.init(seed=5))
    assert_states_equal(restored, es)


def test_resume_continues_from_the_latest_step(tmp_path):
    """A run stopped after 2 steps and resumed to 4 ends in the same state,
    bit for bit, as a run of 4 steps straight through."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    base = [*SMALL, "--no-post-train", "--save-rate", "2"]
    straight = cli.main([*base, "--steps", "4", "--out", a])
    cli.main([*base, "--steps", "2", "--out", b])
    resumed = cli.main([*base, "--steps", "4", "--out", b, "--resume"])
    log = open(os.path.join(_run_dir(b), "log.txt")).read()
    assert "resumed from" in log and "step_0000002 at step 2" in log
    assert resumed.explr_step == 4
    assert_states_equal(resumed, straight)


@pytest.mark.parametrize("flags", [
    ["--backend", "arm"], ["--backend", "arm-dynamic"], ["--backend", "arm-dynamic-soft"],
    ["--method", "uniform"], ["--method", "randomWalk"], ["--host-loop"], ["--panel"],
    ["--web-panel", "0"], ["--dash-every", "5"], ["--profile"], ["--cluster-every", "5"],
    ["--entropy-slices"]])
def test_unported_options_are_rejected(tmp_path, flags):
    with pytest.raises(SystemExit) as e:
        cli.main([*SMALL, "--steps", "2", "--out", str(tmp_path), *flags])
    assert e.value.code == 2
    assert not os.listdir(tmp_path)  # rejected before the run dir is made


def test_cuda_device_without_a_card_is_rejected(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        cli.main(["--small", "--steps", "2", "--out", str(tmp_path)])

"""The port's demo and study CLIs at ``--small --device cpu`` and a few
steps (``runtime/demo.py``, ``scripts/replay_run.py``, ``batch_tests.py``,
``force_study.py``, ``resume_study.py``), and the run entry's dashboard,
profiler, entropy-slice and figure output. Port only: the JAX CLIs run the
same protocols on the JAX package, so the files written are held to the
names the JAX scripts write.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ealv_tpu_torch.runtime import demo
from ealv_tpu_torch.scripts import batch_tests, collect_test_set, force_study, \
    replay_run, resume_study
from ealv_tpu_torch.scripts import run_experiment as cli
from test_torch_trainer import one_torch_thread  # noqa: F401

SMALL = ["--small", "--device", "cpu", "--chunk", "2"]


def _run_dir(out, method="entklerg"):
    return os.path.join(out, "synth", f"{method}_0000")


def test_demo_runs_and_reports_a_rate(capsys):
    """Three chunks of 2 ticks; the first is warm-up and stays out of the
    rate."""
    es, rate = demo.main(["--steps", "6", "--chunk", "2", "--device", "cpu"])
    assert es.explr_step == 6 and es.learning_ind > 0 and rate > 0
    out = capsys.readouterr().out
    assert out.count("[demo] step") == 3 and "steady-state" in out and "on cpu" in out


def test_replay_run_redraws_a_finished_run(tmp_path):
    """A 4-step run, then its replay with a 9-point test set at the run's
    48x48 images: the training curves, the view with its reconstruction and
    the evaluation panels, from the latest checkpoint."""
    out = str(tmp_path / "run")
    cli.main([*SMALL, "--steps", "4", "--no-post-train", "--out", out])
    ts = str(tmp_path / "ts.npz")
    collect_test_set.main(["--n", "9", "--img", "48", "--device", "cpu", "--out", ts])
    paths, metrics = replay_run.main(["--run", _run_dir(out), "--test-set", ts,
                                      "--device", "cpu", "--out", str(tmp_path / "replay")])
    assert [os.path.basename(p) for p in paths] == ["replay_training.png", "replay_view.png"]
    assert sorted(os.listdir(tmp_path / "replay")) == [
        "eval_0.png", "eval_1.png", "eval_2.png", "eval_3.png", "replay_training.png",
        "replay_view.png"]
    assert metrics["recon_mse"].shape == (9,) and np.isfinite(metrics["mean_nll"])


def test_replay_run_without_a_checkpoint_fails(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    (d / "config.yaml").write_text("states: xyw\n")
    with pytest.raises(SystemExit) as e:
        replay_run.main(["--run", str(d), "--device", "cpu"])
    assert e.value.code == 1


@pytest.fixture
def one_thread_children(monkeypatch):
    """The CLIs' child processes run torch on one thread too (the test
    processes share the machine's cores)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_batch_tests_runs_each_method_and_seed(tmp_path, one_thread_children):
    """Two methods, one seed: one run-entry process each, in order, each
    writing its run dir."""
    out = str(tmp_path / "runs")
    cmds = batch_tests.main(["--methods", "entklerg", "uniform", "--steps", "2", "--small",
                             "--device", "cpu", "--out", out])
    assert [c[c.index("--method") + 1] for c in cmds] == ["entklerg", "uniform"]
    assert all(c[:3] == [sys.executable, "-m", "ealv_tpu_torch.scripts.run_experiment"]
               for c in cmds)
    for method in ("entklerg", "uniform"):
        assert os.path.exists(os.path.join(_run_dir(out, method), "checkpoints", "postexplr"))


def test_force_study_runs(capsys):
    """xyz with the force variant on the contact-rich scene: 6 steps, the
    in-distribution reconstruction over the ring and the cross-decoded force
    at the 14 probe poses."""
    res = force_study.main(["--small", "--device", "cpu", "--steps", "6",
                            "--eval-samples", "4"])
    assert res["steps"] == 6 and res["samples"] == 6 and res["probes"] == 14
    assert np.isfinite(res["recon"]["mae"]) and np.isfinite(res["cross"]["mae"])
    out = capsys.readouterr().out
    assert "in-distribution force recon on 4 samples" in out and "cross-decode probes" in out


def test_force_study_from_a_start_in_contact():
    """Started 3 cm below the top of the first object: the ring holds
    pressed samples after 12 steps, and the reconstruction's correlation
    with the true force is defined (the forces vary)."""
    res = force_study.main(["--small", "--device", "cpu", "--steps", "12",
                            "--eval-samples", "12", "--start", "0.42", "-0.06", "0.35"])
    assert res["contact"] > 0 and np.isfinite(res["recon"]["corr"])


def test_resume_study_is_bit_equal(tmp_path, capsys, one_thread_children):
    """A run of 4 steps straight through, and one SIGKILLed past its step-2
    checkpoint and resumed from it: the final checkpoints equal leaf for
    leaf, bit for bit."""
    n = resume_study.main(["--small", "--device", "cpu", "--steps", "4", "--chunk", "2",
                           "--save-rate", "2", "--out", str(tmp_path / "study")])
    assert n > 100
    out = capsys.readouterr().out
    assert "killed at step" in out and "ALL LEAVES BIT-EQUAL" in out
    assert "latest checkpoint at step 2; resuming" in out
    assert not os.path.exists(tmp_path / "study")  # removed without --keep


def test_resume_study_names_the_differing_leaves(tmp_path):
    """The comparison fails on one changed bit and names the leaf."""
    for side, step in (("a", 0), ("b", 1)):
        ck = tmp_path / side / "checkpoints"
        ck.mkdir(parents=True)
        torch.save({"model": {"w": torch.tensor([1.0, float(step)])}, "n": 3},
                   ck / "step_0000004")
    with pytest.raises(SystemExit, match="1 leaves differ"):
        resume_study.compare_final(str(tmp_path / "a"), str(tmp_path / "b"))


def test_run_entry_dashboard_profile_and_slices(tmp_path):
    """--dash-every 2, --profile and --entropy-slices over 4 steps in
    chunks of 2: the dashboard frame and page, a Chrome trace of the second
    chunk naming the planner's ops, the slice figure of an xyw run
    (entropy_dist_all.png, as the JAX script names it) and the end-of-run
    figures."""
    out = str(tmp_path / "run")
    cli.main([*SMALL, "--steps", "4", "--no-post-train", "--dash-every", "2", "--profile",
              "--entropy-slices", "--out", out])
    d = _run_dir(out)
    assert sorted(f for f in os.listdir(d) if not os.path.isdir(os.path.join(d, f))) == [
        "config.yaml", "dashboard.html", "dashboard.png", "entropy_dist_all.png",
        "final_view.png", "log.txt", "metrics.npz", "metrics_summary.json", "training.png"]
    with open(os.path.join(d, "profile", "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("topk" in n for n in names)  # the planner's history draw
    log = open(os.path.join(d, "log.txt")).read()
    assert "profiler trace -> " in log and "entropy slice -> " in log


def test_run_entry_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing, a run logs one line naming the figures
    it did not draw, and --dash-every / --entropy-slices stop the run
    before its directory is made, with ImportError naming matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "run")
    cli.main([*SMALL, "--steps", "2", "--no-post-train", "--out", out])
    log = open(os.path.join(_run_dir(out), "log.txt")).read()
    assert ("figures not drawn (matplotlib is not installed): training.png, "
            "final_view.png") in log
    assert not [f for f in os.listdir(_run_dir(out)) if f.endswith(".png")]
    for flag in (["--dash-every", "2"], ["--entropy-slices"]):
        empty = tmp_path / flag[0].strip("-")
        with pytest.raises(ImportError, match="matplotlib"):
            cli.main([*SMALL, "--steps", "2", "--out", str(empty), *flag])
        assert not empty.exists()

"""The port's run entry point, ``python -m ealv_tpu_torch.scripts.run_experiment``,
at ``--small --device cpu``: the run directory it writes, ``--resume``
picking up the latest checkpoint, the arm backends, the host loop with the
control panel, the clustering monitor, and the options it does not port
being rejected. Port only; the run loop is called in-process through
``main``.
"""

import json
import os
import signal

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
    ["--web-panel", "0"], ["--dash-every", "5"], ["--profile"], ["--entropy-slices"],
    ["--panel"]])
def test_unported_options_are_rejected(tmp_path, flags):
    """The options not ported yet, and the panel without the host loop it
    drives, stop the run before its directory is made."""
    with pytest.raises(SystemExit) as e:
        cli.main([*SMALL, "--steps", "2", "--out", str(tmp_path), *flags])
    assert e.value.code == 2
    assert not os.listdir(tmp_path)  # rejected before the run dir is made


@pytest.mark.parametrize("flags,config", [
    (["--method", "uniform"], None), (["--method", "randomWalk", "--states", "xywb"], None),
    (["--states", "xywb"], "learn_force: true\nuse_z_ensemble: true\n")])
def test_baselines_and_variants_run(tmp_path, flags, config):
    """A baseline explorer, the brightness state, and the force variant
    with the z-ensemble from a --config yaml: 3 steps and post-training to
    9 trainer calls, finite losses, the options in the written config."""
    out = str(tmp_path / "run")
    extra = []
    if config:
        path = tmp_path / "cfg.yaml"
        path.write_text(config)
        extra = ["--config", str(path)]
    es = cli.main([*SMALL, "--steps", "3", "--out", out, *flags, *extra])
    assert es.explr_step == 3 and es.learning_ind == 9
    method = flags[flags.index("--method") + 1] if "--method" in flags else "entklerg"
    d = os.path.join(out, "synth", f"{method}_0000")
    m = np.load(os.path.join(d, "metrics.npz"))
    assert np.isfinite(m["loss"]).all() and m["loss"].shape == (3 + 9 - 2,)
    cfg = open(os.path.join(d, "config.yaml")).read()
    assert f"explr_method: {method}" in cfg
    if config:
        assert "learn_force: true" in cfg and "use_z_ensemble: true" in cfg
        assert es.model.learn_force and int(es.mstate.z_buff.abs().sum() > 0)
    if "xywb" in flags:
        assert "states: xywb" in cfg and es.buf.x.shape[1] == 4


@pytest.mark.parametrize("backend", ["arm", "arm-dynamic", "arm-dynamic-soft"])
def test_arm_backends_run(tmp_path, backend):
    """Each arm backend through the chunked loop: 3 steps and
    post-training, the backend in the written config, the arm's joints in
    the final state."""
    out = str(tmp_path / "run")
    es = cli.main([*SMALL, "--steps", "3", "--out", out, "--backend", backend])
    assert es.explr_step == 3 and es.learning_ind == 9 and es.env.count == 3
    cfg = open(os.path.join(_run_dir(out), "config.yaml")).read()
    assert f"sim_backend: {backend}" in cfg
    m = np.load(os.path.join(_run_dir(out), "metrics.npz"))
    assert np.isfinite(m["loss"]).all() and np.isfinite(es.env.q.numpy()).all()


@pytest.fixture()
def signal_handlers():
    """The host loop installs its SIGINT/SIGTERM handlers; put the test
    process's back."""
    before = {s: signal.getsignal(s) for s in (signal.SIGINT, signal.SIGTERM)}
    yield
    for s, h in before.items():
        signal.signal(s, h)


@pytest.mark.parametrize("backend", ["arm", "arm-dynamic", "arm-dynamic-soft"])
def test_host_loop_with_panel_runs(tmp_path, monkeypatch, signal_handlers, backend):
    """--host-loop --panel on each arm backend: goal seeking to the start
    pose, exactly --steps steps through the bridge in blocks of --chunk,
    the panel's save command served as a checkpoint, the run's events and
    the final checkpoint; no post-training, as in the JAX script."""
    import io
    import sys
    import time
    monkeypatch.setattr(sys, "stdin", io.StringIO("save\n"))
    out = str(tmp_path / "run")
    orig = cli.HostLoopRunner.run

    def run(self, es, n):  # let the panel's thread read its line first
        for _ in range(1000):
            if self.pause.save_requested or self.events.count("save"):
                break
            time.sleep(0.01)
        return orig(self, es, n)

    monkeypatch.setattr(cli.HostLoopRunner, "run", run)
    es = cli.main([*SMALL, "--steps", "5", "--out", out, "--backend", backend, "--host-loop",
                   "--panel"])
    assert es.explr_step == 5 and es.learning_ind == 4
    d = _run_dir(out)
    log = open(os.path.join(d, "log.txt")).read()
    assert "host-loop done: 5 steps" in log and "[save] checkpoint at step 1" in log
    cks = sorted(os.listdir(os.path.join(d, "checkpoints")))
    assert cks == ["step_0000001", "step_0000005"]
    assert signal.getsignal(signal.SIGTERM) != signal.SIG_DFL  # the killer listens


def test_cluster_monitor_runs(tmp_path):
    """--cluster-every 2 over 4 steps in chunks of 2: two monitor passes
    logged and written to clusters/cluster_log.csv."""
    out = str(tmp_path / "run")
    es = cli.main([*SMALL, "--steps", "4", "--out", out, "--cluster-every", "2",
                   "--no-post-train"])
    assert es.explr_step == 4
    d = _run_dir(out)
    log = open(os.path.join(d, "log.txt")).read()
    assert log.count("clusters @ ") == 2 and "clusters @ 4:" in log
    with open(os.path.join(d, "clusters", "cluster_log.csv")) as f:
        rows = f.read().strip().splitlines()
    assert rows[0].startswith("step,error") and [r.split(",")[0] for r in rows[1:]] == ["2", "4"]


def test_cuda_device_without_a_card_is_rejected(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit):
        cli.main(["--small", "--steps", "2", "--out", str(tmp_path)])

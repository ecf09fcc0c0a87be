"""The port's fingerprint CLIs (``ealv_tpu_torch/scripts/``), run in-process
on the CPU: the method matrix end to end at the small config (its table
read back by the study's parser; on the arm and through the host loop in
``test_torch_fp_cli_arm.py``), the
manual captures from a checkpoint of the port, and the belief-peak and
workspace photos against the JAX scripts' own outputs; ``k3_study``'s
parser and aggregation on the JAX script's log text and its ``python -m``
command line.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from ealv_tpu_torch.fingerprint import belief as tbel, capture as tcap, io as tio
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.runtime.checkpoint import save_checkpoint
from ealv_tpu_torch.scripts import (build_manual_fingerprints, capture_fingerprint_belief,
                                    capture_ws, k3_study, run_fingerprint_matrix)
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_fingerprint import TINY
from test_torch_trainer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_matrix(capsys, *extra):
    rt, table = run_fingerprint_matrix.main(
        ["--small", "--device", "cpu", "--learn-steps", "4", "--id-steps", "3",
         "--capture-steps", "3", *extra])
    return rt, table, capsys.readouterr().out


def test_matrix_cli_end_to_end(tmp_path, capsys):
    """Learn 4 steps, capture at the 2 objects of a made scene, 3 steps of
    the four-combination matrix; the printed table and the belief files."""
    out = str(tmp_path / "mx")
    rt, table, text = run_matrix(capsys, "--objects", "2", "--seed", "3", "--out", out)
    assert "4 learning steps in" in text and "true centers (robot):" in text
    assert "calibrated BC: thresh" in text and "| L2 |" in text
    log = tmp_path / "log.txt"
    log.write_text(text)
    parsed = k3_study.parse_log(str(log))
    assert set(parsed) == {"L2", "KL", "BC", "L2_error"}
    for key, row in table.items():
        np.testing.assert_allclose(parsed[key], np.round(row["error"], 3), atol=1e-9)
    for combo in ("L2", "KL", "BC", "L2_error"):
        with np.load(os.path.join(out, f"beliefs_{combo}.npz")) as z:
            assert z["priors"].shape == (2, 125_000) and np.isfinite(z["priors"]).all()
            assert (z["counts"] == 6).all() or combo == "L2_error"


def test_matrix_cli_uncertain_seek_mode(tmp_path, capsys):
    """--seek-mode uncertain on the default tray: the largest-entropy
    object of every step (picked from the first step on; adopted from step
    10) and its share, printed as the study parses it."""
    rt, _, text = run_matrix(capsys, "--seek-mode", "uncertain")
    assert rt.seek_mode == "uncertain" and rt.seek_history.shape == (3,)
    log = tmp_path / "log.txt"
    log.write_text(text)
    share = k3_study.parse_log(str(log))["seek_share"]
    want = [round(float((rt.seek_history == k).mean()), 2) for k in range(2)]
    assert share == want and rt.seek_history[0] == 0  # equal entropies: the first


def test_build_manual_fingerprints_from_a_checkpoint(tmp_path, capsys):
    """Two captures from a saved run state equal direct captures with its
    model."""
    cfg = ExperimentConfig(**TINY)
    cfg.to_yaml(str(tmp_path / "config.yaml"))
    exp = Experiment(cfg, device="cpu")
    es = exp.init(seed=5)
    ck = save_checkpoint(str(tmp_path / "ck"), es)
    paths = build_manual_fingerprints.main(
        ["--config", str(tmp_path / "config.yaml"), "--ckpt", ck, "--steps", "3",
         "--centers=-0.4,-0.4,0;0.4,0.5,0", "--out", str(tmp_path / "fps"), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["manual_0_sphere.npz",
                                                    "manual_1_sphere.npz"]
    want = tcap.capture_fingerprint(es.model, cfg, np.array([0.4, 0.5, 0.0], np.float32),
                                    num_steps=3, seed=1, device="cpu")
    loaded = tio.load_fingerprints(str(tmp_path / "fps"))
    for k, v in want.items():
        np.testing.assert_array_equal(loaded[1][k], v)
    assert "fingerprint 1: " in capsys.readouterr().out


def test_capture_fingerprint_belief_matches_the_jax_script(tmp_path, monkeypatch):
    """The same belief file: each peak's pose and image as the JAX script
    saves them."""
    bs = [tbel.FingerprintBelief.create("xyw", [[-1, 1]] * 3, num_samples=8, device="cpu")
          for _ in range(2)]
    rng = np.random.default_rng(0)
    bs = [dataclasses.replace(b, prior=torch.tensor(rng.uniform(0, 1, 512), dtype=torch.float32))
          for b in bs]
    path = tio.save_beliefs(str(tmp_path / "beliefs"), bs)
    got = capture_fingerprint_belief.main(["--beliefs", path, "--out",
                                           str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["capture_fingerprint_belief.py", "--beliefs", path,
                                      "--out", str(tmp_path / "jax")])
    jax_script("capture_fingerprint_belief").main()
    for k, p in enumerate(got):
        with np.load(p) as a, np.load(tmp_path / "jax" / f"belief_cap_{k}.npz") as b:
            np.testing.assert_allclose(a["pose"], b["pose"], atol=1e-6)
            np.testing.assert_allclose(a["image"], b["image"], atol=1e-5)


def test_capture_ws_matches_the_jax_script(tmp_path, monkeypatch):
    import matplotlib.pyplot as plt
    out = capture_ws.main(["--out", str(tmp_path / "port.png"), "--img", "40", "--device",
                           "cpu"])
    monkeypatch.setattr(sys, "argv", ["capture_ws.py", "--out", str(tmp_path / "jax.png"),
                                      "--img", "40"])
    jax_script("capture_ws").main()
    a, b = plt.imread(out), plt.imread(str(tmp_path / "jax.png"))
    assert a.shape == b.shape == (40, 40, 4)
    np.testing.assert_allclose(a, b, atol=1.01 / 255)


# the JAX script's test log (tests/test_k3_study.py)
LOG = """+ python scripts/run_fingerprint_matrix.py --objects 3
800 learning steps in 19s; loss -3.780
seek-target share per object (post-adoption): [0.31, 0.53, 0.16]

| method | per-object error | mean error |
|---|---|---|
| L2 | 0.377, 0.124, 0.452 | 0.318 |
| KL | 0.377, 0.982, 0.411 | 0.590 |
| BC | 0.377, 0.908, 0.411 | 0.565 |
| L2_error | 1.282, 0.185, 0.564 | 0.677 |
"""


def test_k3_study_parses_like_the_jax_script(tmp_path):
    p = tmp_path / "log.txt"
    p.write_text(LOG)
    assert k3_study.parse_log(str(p)) == jax_script("k3_study").parse_log(str(p))
    assert k3_study.parse_log(str(p))["seek_share"] == [0.31, 0.53, 0.16]
    assert k3_study.parse_log(str(tmp_path / "missing.txt")) is None


def test_k3_study_parse_only_aggregates_like_the_jax_script(tmp_path, capsys):
    """--parse-only over two seeds' logs: the same summary.json and
    summary.md as the JAX script's, and exit 1 naming a missing run."""
    jk3 = jax_script("k3_study")
    for root in ("port", "jax"):
        for seed, tbl in ((0, "| L2 | 0.3, 0.1, 0.5 | 0.3 |"), (1, LOG)):
            d = tmp_path / root / f"s{seed}_active"
            d.mkdir(parents=True)
            (d / "log.txt").write_text("| method | per-object error | mean error |\n" + tbl)
    k3_study.main(["--parse-only", "--seeds", "0", "1", "--modes", "active", "--out",
                   str(tmp_path / "port")])
    sys_argv = sys.argv
    try:
        sys.argv = ["k3_study.py", "--parse-only", "--seeds", "0", "1", "--modes", "active",
                    "--out", str(tmp_path / "jax")]
        jk3.main()
    finally:
        sys.argv = sys_argv
    for name in ("summary.json", "summary.md"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    st = json.loads((tmp_path / "port" / "summary.json").read_text())["summary"]["active"]
    assert st["L2"]["worst_object_max"] == 0.5
    with pytest.raises(SystemExit) as ei:
        k3_study.main(["--parse-only", "--seeds", "0", "2", "--modes", "active", "--out",
                       str(tmp_path / "port")])
    assert ei.value.code == 1
    assert "INCOMPLETE" in (tmp_path / "port" / "summary.md").read_text()


def test_k3_study_runs_the_port_matrix_as_a_module(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(k3_study.subprocess, "call",
                        lambda cmd, **kw: calls.append((cmd, kw["cwd"])) or 0)
    rc = k3_study.run_one(2, "active", str(tmp_path / "s2_active"), True, 10, 5,
                          device="cpu")
    cmd, cwd = calls[0]
    assert rc == 0 and cwd == REPO
    assert cmd[1:3] == ["-m", "ealv_tpu_torch.scripts.run_fingerprint_matrix"]
    assert cmd[cmd.index("--seek-mode") + 1] == "uncertain" and "--small" in cmd
    assert cmd[cmd.index("--device") + 1] == "cpu" and cmd[cmd.index("--seed") + 1] == "2"
    assert (tmp_path / "s2_active" / "log.txt").read_text().startswith("+ ")

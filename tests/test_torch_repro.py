"""The port's table registry (``ealv_tpu_torch/scripts/repro.py``) against
the JAX one (``scripts/repro.py``, loaded from its file here; the port never
reads it): the same tables, each with the same arguments, flags and
documentation once ``scripts/<cli>.py`` reads
``-m ealv_tpu_torch.scripts.<cli>``; ``bench`` raises; ``soak`` without
matplotlib drops ``--dash-every`` and says so; one ``--small --device
cpu`` table end to end; the port's ``planner`` table at a tiny size.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from ealv_tpu_torch.scripts import repro
from test_torch_trainer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_repro():
    spec = importlib.util.spec_from_file_location(
        "jax_repro", os.path.join(REPO, "scripts", "repro.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_module(cmd):
    """A JAX command [python, <repo>/scripts/<cli>.py, *args] as the port
    writes it: [python, -m, ealv_tpu_torch.scripts.<cli>, *args]."""
    script = os.path.relpath(cmd[1], REPO)
    assert script.startswith("scripts" + os.sep) and script.endswith(".py"), script
    return [cmd[0], "-m", "ealv_tpu_torch.scripts." + os.path.basename(script)[:-3], *cmd[2:]]


def test_list_names_planner_and_every_jax_table(jax_repro):
    r = subprocess.run([sys.executable, "-m", "ealv_tpu_torch.scripts.repro", "--list"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    listed = [line.split()[0] for line in r.stdout.splitlines()[1:]]
    assert listed == ["planner", *jax_repro.TABLES]
    assert list(repro.TABLES) == list(jax_repro.TABLES)


def test_unknown_table_is_refused():
    with pytest.raises(SystemExit):
        repro.main(["not-a-table"])


@pytest.mark.parametrize("name", [n for n in repro.TABLES if n != "bench"])
def test_each_command_is_the_jax_command_with_the_module_path(jax_repro, name):
    want, got = jax_repro.TABLES[name], repro.TABLES[name]
    assert got["cmd"] == _as_module(want["cmd"])
    for key in ("doc", "out", "small_ok"):
        assert got.get(key) == want.get(key), key


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("name", ["matrix", "force", "resume", "k3-study"])
def test_run_adds_out_small_and_device_as_the_jax_script_does(name, small, tmp_path):
    """``--out`` where the table writes files, ``--small`` only where it
    has a small variant (else a note), then ``--device``."""
    spec = repro.TABLES[name]
    cmd, notes = repro.table_command(name, small=small, device="cpu", out_dir=str(tmp_path))
    tail = (["--out", str(tmp_path)] if spec.get("out") else []) \
        + (["--small"] if small and spec.get("small_ok") else []) + ["--device", "cpu"]
    assert cmd == spec["cmd"] + tail
    assert bool(notes) == (small and not spec.get("small_ok"))


def test_bench_raises_naming_item_11b(jax_repro):
    assert "bench" in jax_repro.TABLES
    with pytest.raises(NotImplementedError, match="item 11b"):
        repro.table_command("bench")
    with pytest.raises(NotImplementedError, match="item 11b"):
        repro.run_table("bench", device="cpu")


def test_soak_without_matplotlib_drops_dash_every_and_says_so(monkeypatch):
    monkeypatch.setattr(repro, "_has_matplotlib", lambda: False)
    cmd, notes = repro.table_command("soak", device="cuda", out_dir="o")
    want = list(repro.TABLES["soak"]["cmd"])
    i = want.index("--dash-every")
    assert cmd == want[:i] + want[i + 2:] + ["--out", "o", "--device", "cuda"]
    assert len(notes) == 1 and "--dash-every 500" in notes[0] and "matplotlib" in notes[0]
    monkeypatch.setattr(repro, "_has_matplotlib", lambda: True)
    cmd, notes = repro.table_command("soak", device="cuda", out_dir="o")
    assert cmd == want + ["--out", "o", "--device", "cuda"] and not notes


def test_a_small_table_runs_end_to_end_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``matrix --small --device cpu`` as a user runs it: the CLI in a
    subprocess, its output in ``<table>/log.txt`` and its belief files in
    the table's directory, exit code 0. The pinned 600 + 300 steps take
    over a quarter of an hour on a CPU, so the registry's step counts are
    cut here to 6 learning, 3 capture and 4 identification steps (the
    pinned command line itself is held against the JAX one above)."""
    cmd = list(repro.TABLES["matrix"]["cmd"])
    cmd[cmd.index("--learn-steps") + 1] = "6"
    cmd[cmd.index("--id-steps") + 1] = "4"
    monkeypatch.setitem(repro.TABLES, "matrix", {**repro.TABLES["matrix"],
                                                 "cmd": cmd + ["--capture-steps", "3"]})
    rc = repro.run_table("matrix", small=True, device="cpu", out_root=str(tmp_path))
    out = capsys.readouterr().out
    assert rc == 0, out[-2000:]
    log = (tmp_path / "matrix" / "log.txt").read_text()
    assert "--capture-steps 3 --out " in out and "--small --device cpu" in out
    assert "6 learning steps" in log and "4-step matrix identification" in log
    assert "| method | per-object error | mean error |" in log
    saved = [line.split(" -> ")[1] for line in log.splitlines() if line.startswith("beliefs[")]
    assert len(saved) == 4 and all(os.path.dirname(p) == str(tmp_path / "matrix")
                                   and os.path.exists(p) for p in saved)


def test_planner_table_at_a_tiny_size(tmp_path):
    """2 seeds x 5 steps at 64 x 50 samples: one port row a seed with the
    published columns, finite, beside the published rows, and a port
    mean±std row beside the published aggregates."""
    rows, table = repro.planner_study(seeds=(0, 1), steps=5, out_dir=str(tmp_path),
                                      device="cpu", num_target_samples=64,
                                      num_traj_samples=50)
    port = [m for impl, _, m in rows if impl == "port"]
    assert [s for impl, s, _ in rows] == [0, 1] and len(port) == 2
    for m in port:
        assert set(m) == {"late_x", "frac_x_neg", "y_std", "steps_per_s"}
        assert np.isfinite(list(m.values())).all() and 0 <= m["frac_x_neg"] <= 1
    lines = table.splitlines()
    assert lines[0] == "| seed | impl | late-x mean | frac(x<0) | y-std | steps/s |"
    assert sum(" | port | " in line for line in lines) == 3
    assert "| mean±std (2 seeds) | port |" in table
    assert "| mean±std (10 seeds) | ealv | -0.221±0.061 | 0.74±0.04 | 0.62±0.02 | |" in table
    assert (tmp_path / "planner_table.md").read_text() == table + "\n"
    with open(repro.PUBLISHED_PLANNER) as f:
        published = [line.rstrip("\n") for line in f if "| ealv |" in line or "| torch |" in line]
    assert all(line in lines for line in published if "mean" not in line)

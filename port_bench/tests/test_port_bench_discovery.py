"""A configuration, a traffic mix, a metric and a cell are found by name:
a later change adds files and entries and edits none."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found_without_editing_any(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "port_bench").rglob("*") if p.is_file()}
    pb = tmp_path / "port_bench"
    conf = json.loads((pb / "configs" / "xyzrpw.json").read_text())
    conf["config"]["states"] = "xyz"
    (pb / "configs" / "xyz.json").write_text(json.dumps(conf))
    # a new entry of the program, and a traffic mix that drives it
    (pb / "entries" / "identify.py").write_text(
        "from port_bench.entries import eval as base\n\n\n"
        "class Entry(base.Entry):\n    kind = 'identify'\n")
    traffic = json.loads((pb / "traffic" / "eval.json").read_text())
    traffic.update(entry="identify", chunk=30)
    (pb / "traffic" / "identify.json").write_text(json.dumps(traffic))
    (pb / "metrics" / "ticks_seen.py").write_text("def read(run):\n    return run['ticks']\n")
    (pb / "limits" / "xyz.identify.json").write_text('{"image": 0.012}')
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0], name="xyz",
                                    file="port_bench/configs/xyz.json"))
    manifest["workloads"].append({"name": "xyz.identify", "config": "xyz",
                                  "traffic": "identify", "chips": 1, "why": "a test cell"})
    manifest["per_layer"].append({"name": "ticks_seen", "unit": "ticks", "better": "higher",
                                  "source": "program_counter", "layer": "harness",
                                  "moves": "tick_ms", "workloads": ["xyz.identify"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import json; from port_bench import drive, harness, run\n"
            "f = harness.cell_files('xyz.identify')\n"
            "e = drive.entry(f['traffic'])\n"
            "print(json.dumps([f['config']['states'], f['traffic']['chunk'], f['limits'],"
            " run.per_layer(f, {'ticks': 7}), e.__module__, e.kind]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    states, chunk, limits, metrics, module, kind = json.loads(out.strip().splitlines()[-1])
    assert (states, chunk, limits) == ("xyz", 30, {"image": 0.012})
    assert metrics == {"ticks_seen": {"value": 7, "unit": "ticks"}}
    assert (module, kind) == ("port_bench.entries.identify", "identify")
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_run_outside_a_checkout_of_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run exits with another code than 0 and prints no result."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "xyzrpw.eval",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""

"""The last line and the import guard."""

import json

import pytest

from port_bench import harness, run


def _record(**kw):
    r = dict(ticks=50, window_s=2.5, gaps_s=[0.05] * 50, host_s=[0.001] * 50,
             trained=[i % 3 == 0 for i in range(50)], setup_s=20.0, nonfinite=0,
             captured_in_window=0, memory_peak_bytes=123, flops=1e12, traced=None,
             gaps={"cost": 1e-7, "image": 0.0, "state": 0.0, "start": 0.0, "plan": 0.3},
             per_tick=[{"cost": 1e-7, "image": 0.0, "state": 0.0}])
    r.update(kw)
    return r


def _files():
    return harness.cell_files("xyzrpw.eval")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr("torch.cuda.get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")


def test_the_last_line_has_the_five_keys_and_checks_last(no_card):
    line = run.result(_files(), _record(), trace_on=False)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] == 50 and line["failed"] == 0
    assert set(line["metrics"]) == {"tick_ms", "tick_p95_ms", "setup_s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert set(line["checks"]) == set(_files()["limits"])
    json.loads(json.dumps(line))


def test_a_number_over_its_limit_or_missing_fails(no_card):
    files = _files()
    over = _record(gaps={"cost": 1e-7, "image": 0.5, "state": 0.0, "start": 0.0},
                   per_tick=[{"cost": 1e-7, "image": 0.5, "state": 0.0},
                             {"cost": 1e-7, "image": 0.0, "state": 0.0}])
    line = run.result(files, over, trace_on=False)
    assert line["correct"] is False and line["failed"] == 1
    missing = _record(gaps={"cost": 1e-7, "image": 0.0, "start": 0.0})  # no state
    line = run.result(files, missing, trace_on=False)
    assert line["correct"] is False and line["checks"]["state"]["value"] == run.MISSING
    assert run.result(files, _record(nonfinite=2), False)["correct"] is False
    assert run.result(files, _record(captured_in_window=1), False)["correct"] is False


def test_the_traced_line_has_busy_window_and_breakdown(no_card):
    traced = dict(window_s=1.2, busy_s=1.1, k1_s=0.01, k1_bound_s=0.001,
                  device_ops=[["k", 0.5]], idle_gaps=[["tick", 0.01]])
    line = run.result(_files(), _record(traced=traced), trace_on=True)
    assert line["device"]["busy_s"] == 1.1 and line["device"]["window_s"] == 1.2
    assert line["breakdown"] == {"device_ops": [["k", 0.5]], "idle_gaps": [["tick", 0.01]]}
    assert {"host_ms_per_tick", "k1_roofline", "mfu_pct"} == set(line["metrics"])


@pytest.mark.parametrize("names,found", [
    (["torch", "ealv_tpu_torch", "ealv_tpu_torch.runtime", "port_bench"], []),
    (["ealv_tpu"], ["ealv_tpu"]),
    (["ealv_tpu.ops.kernels"], ["ealv_tpu.ops.kernels"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["jaxtyping", "ealv_tpu_torchx"], []),
])
def test_the_import_guard_compares_top_level_names_whole(names, found):
    assert harness.banned_modules(names) == found


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert run.main(["--workload", "xyzrpw.eval", "--seed", "3", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err

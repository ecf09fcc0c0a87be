"""The metric arithmetic on synthetic ticks, events and traces."""

import importlib

import pytest

from port_bench import harness, trace


def test_p95_is_the_nearest_rank_over_all_ticks():
    values = list(range(1, 101))  # 1..100
    assert harness.p95(values) == 95
    assert harness.p95([3.0]) == 3.0
    # 40 ticks: rank ceil(38) = 38
    assert harness.p95(list(range(40))) == 37
    # a trainer tick every third tick: the tail falls among them
    gaps = [10.0, 10.0, 120.0] * 100
    assert harness.p95(gaps) == 120.0


def test_busy_time_is_the_union_of_the_device_work():
    # device work 0-10, 5-20 (overlap), 30-40; window 0-50 -> busy 30
    device = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 60, 70)]
    assert trace.busy_ns(device, 0, 50) == 30
    assert trace.busy_ns(device, 8, 35) == 17


def test_idle_gaps_are_named_by_the_host_span_over_them():
    device = [("k", 0, 10), ("k", 30, 40), ("k", 45, 50)]
    host = [("chunk", 0, 60), ("tick", 12, 28), ("readback", 50, 60)]
    gaps = trace.idle_gaps(device, host, 0, 60)
    assert gaps == [["tick", 20e-9], ["readback", 10e-9], ["chunk", 5e-9]]
    assert trace.by_name(device, 0, 60) == {"k": 25e-9}


def test_tick_ms_covers_the_final_drain():
    """``tick_ms`` is the window's seconds, which end with the synchronize
    of the last chunk's read, over the ticks: a drain after the last event
    counts."""
    from port_bench import run
    r = {"window_s": 2.0, "ticks": 40, "gaps_s": [0.04] * 40, "setup_s": 12.5}
    files = {"cell": {"name": "c"}, "end_to_end": [
        {"name": "tick_ms", "unit": "ms"}, {"name": "tick_p95_ms", "unit": "ms"},
        {"name": "setup_s", "unit": "s"}]}
    m = run.end_to_end(files, r)
    assert m["tick_ms"]["value"] == pytest.approx(50.0)  # not the 40 ms of the gaps
    assert m["tick_p95_ms"]["value"] == pytest.approx(40.0)
    assert m["setup_s"] == {"value": 12.5, "unit": "s"}


def test_readers_and_what_they_find_nothing_in():
    r = {"gaps_s": [0.1, 0.01, 0.01, 0.1], "host_s": [0.002] * 4,
         "trained": [False] * 4, "window_s": 0.22, "flops": 989e12 * 0.22 / 100,
         "traced": {"k1_s": 2.0, "k1_bound_s": 0.5, "busy_s": 1, "window_s": 1}}
    read = lambda name, run: importlib.import_module(f"port_bench.metrics.{name}").read(run)
    assert read("host_ms_per_tick", r) == pytest.approx(2.0)
    assert read("k1_roofline", r) == pytest.approx(25.0)
    assert read("mfu_pct", r) == pytest.approx(1.0)
    untraced = dict(r, traced=None)
    assert read("k1_roofline", untraced) is None
    no_k1 = dict(r, traced=dict(r["traced"], k1_s=0.0))
    assert read("k1_roofline", no_k1) is None

"""The program's spans in the run record, the eight readers of them, and the
hooks by which an entry brings its own compared numbers, FLOPs and K1
launches. On the CPU the tracer's device stamps take the host clock."""

import importlib
import time

import pytest

from port_bench import compare, counts, drive, harness, run
from port_bench.tests.toy import toy_mix

SEED = 2_900_000_017
SPAN_METRICS = ("stage_ms", "launch_ms", "device_wait_pct", "decode_ms", "descent_ms",
                "env_ms", "absorb_ms", "train_call_ms")


def _early(cell: str) -> dict:
    """The toy cell with its compared ticks drawn among the window's first
    eight, so that a short window on a loaded CPU holds them all."""
    files = toy_mix(cell)
    files["traffic"]["compare"]["within"] = 8
    return files


def _read(name, record):
    return importlib.import_module(f"port_bench.metrics.{name}").read(record)


def _pause():
    time.sleep(2e-4)


def _record_toy_ticks(tracing, n: int):
    """``n`` ticks shaped as a captured learning tick: host spans ``key``,
    ``stage``, ``replay`` and ``clone`` in ``tick``; device spans
    ``decode``, ``descent``, ``env`` and ``absorb`` in ``tick``, and a
    ``train`` inside ``absorb`` every other tick."""
    for i in range(n):
        with tracing.tick():
            for name in ("key", "stage"):
                with tracing.span(name):
                    _pause()
            with tracing.span("replay"):
                tracing.begin("tick")
                for name in ("decode", "descent", "env"):
                    tracing.begin(name)
                    _pause()
                    tracing.end(name)
                tracing.begin("absorb")
                _pause()
                if i % 2 == 0:
                    tracing.begin("train")
                    _pause()
                    tracing.end("train")
                tracing.end("absorb")
                tracing.end("tick")
            with tracing.span("clone"):
                _pause()
        _pause()  # the card waits between ticks


def test_each_reader_on_a_recorded_toy_trace():
    from ealv_tpu_torch.runtime import tracing

    tracing.enable("cpu")
    try:
        _record_toy_ticks(tracing, 2)  # before the window: left out
        first, lo = tracing.ticks(), time.perf_counter_ns()
        _record_toy_ticks(tracing, 6)
        last, hi = tracing.ticks(), time.perf_counter_ns()
        tr = tracing.read(first, last)
    finally:
        tracing.disable()
    record = {"spans": tracing.summary(tr, lo, hi)}
    n = last - first
    assert record["spans"]["ticks"] == n == 6
    ms = lambda spans: sum(s.ns for s in spans) / 1e6
    host = {name: [s for s in tr.host if s.name == name] for name in ("tick", "replay")}
    dev = {name: [s for s in tr.device if s.name == name]
           for name in ("tick", "decode", "descent", "env", "absorb", "train")}
    assert len(host["tick"]) == len(dev["tick"]) == n and len(dev["train"]) == 3
    expected = {
        "stage_ms": (ms(host["tick"]) - ms(host["replay"])) / n,
        "launch_ms": ms(host["replay"]) / n,
        "decode_ms": ms(dev["decode"]) / n,
        "descent_ms": ms(dev["descent"]) / n,
        "env_ms": ms(dev["env"]) / n,
        "absorb_ms": (ms(dev["absorb"]) - ms(dev["train"])) / n,
        "train_call_ms": ms(dev["train"]) / 3,
        "device_wait_pct": (hi - lo - sum(s.ns for s in dev["tick"])) / (hi - lo) * 100.0,
    }
    for name, value in expected.items():
        got = _read(name, record)
        assert value > 0 and got == pytest.approx(value, rel=1e-9), name
    # an eval tick has no absorb and no trainer call
    eval_like = {"spans": dict(record["spans"], device_ms={}, device_self_ms={},
                               device_calls={})}
    assert _read("absorb_ms", eval_like) is None and _read("train_call_ms", eval_like) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_finds_nothing_without_spans(name):
    assert _read(name, {"spans": None}) is None
    assert _read(name, {"ticks": 10, "traced": None}) is None


def test_an_untraced_run_never_turns_the_tracer_on(monkeypatch):
    from ealv_tpu_torch.runtime import tracing

    seen = []

    def watched(fn):
        def call(*a, **kw):
            seen.append(tracing.state())
            out = fn(*a, **kw)
            seen.append(tracing.state())
            return out
        return call

    for name in ("warm", "window", "reference_gaps"):
        monkeypatch.setattr(harness, name, watched(getattr(harness, name)))
    monkeypatch.setattr(drive, "make", watched(drive.make))
    files = toy_mix("xyzrpw.eval")
    r = harness.measure(files, SEED, 0.2, False, device="cpu")
    assert len(seen) == 8 and set(seen) == {None} and tracing.state() is None
    assert r["spans"] is None and r["traced"] is None


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.eval"])
def test_a_traced_run_keeps_the_windows_spans_and_the_hooks_defaults(cell, monkeypatch):
    from ealv_tpu_torch.runtime import tracing

    made = []
    real = compare.tick_gaps
    monkeypatch.setattr(compare, "tick_gaps", lambda *a: made.append(real(*a)) or made[-1])
    files = _early(cell)
    r = harness.measure(files, SEED, 1.0, True, device="cpu")
    assert tracing.state() is None
    cfg, learning = files["config"], files["traffic"]["entry"] == "learn"
    spans = r["spans"]
    assert spans["ticks"] == r["ticks"] and r["config"] == cfg
    readable = {"stage_ms", "device_wait_pct", "decode_ms", "descent_ms", "env_ms"}
    if learning:
        readable |= {"absorb_ms", "train_call_ms"}
    metrics = run.per_layer({"per_layer": [{"name": n, "unit": "ms"} for n in SPAN_METRICS]}, r)
    assert set(metrics) == readable  # on the CPU the tick runs eagerly: no replay
    assert all(m["value"] > 0 for m in metrics.values())
    # the hooks' defaults: the explore and learn ticks' counts, no number added
    assert r["flops"] == sum(counts.tick_flops(cfg, learning, t) for t in r["trained"])
    t = r["traced"]
    assert t["ticks"] == files["traffic"]["chunk"] and isinstance(t["by_name"], dict)
    assert t["k1_bound_s"] == sum(counts.k1_bound_s(*launch)[0] for i in range(t["ticks"])
                                  for launch in counts.k1_tick_launches(cfg, learning,
                                                                        t["fill0"] + i + 1))
    assert len(r["per_tick"]) == files["traffic"]["compare"]["ticks"] and r["per_tick"] == made
    # the idle gaps are named by the program's spans where one covers them
    assert t["idle_gaps"] and t["idle_gaps"][0][0].startswith("ealv.")


class _ImageMeanEntry(importlib.import_module("port_bench.entries.eval").Entry):
    """The eval entry with a compared number of its own: the gap of the
    image's mean pixel."""

    def extra_gaps(self, prog, ref, snap):
        return {"image_mean": abs(float(prog["image"].float().mean()
                                        - ref["image"].float().mean()))}


def _entry_files(tmp_path, monkeypatch):
    monkeypatch.setattr(drive, "entry", lambda traffic: _ImageMeanEntry)
    limits = tmp_path / "xyw.image_mean.json"
    limits.write_text('{"image_mean": 1e-4}')
    files = _early("xyw.eval")
    files["limits"] = harness.load_json(limits)
    return files


def _correct(files, r) -> bool:
    checked, failed = run.checks(files, r)
    return failed == 0 and all(c["value"] <= c["limit"] for c in checked.values())


def test_an_entrys_own_number_passes_a_sound_run(tmp_path, monkeypatch):
    files = _entry_files(tmp_path, monkeypatch)
    r = harness.measure(files, SEED, 0.3, False, device="cpu", controls=("fp8",))
    assert len(r["per_tick"]) == 4 and r["gaps"]["image_mean"] == 0.0 and _correct(files, r)
    assert all("image_mean" in g for g in r["controls_per_tick"]["fp8"])


def test_an_entrys_own_number_fails_a_planted_fault(tmp_path, monkeypatch):
    from ealv_tpu_torch.sim import env as env_mod

    files = _entry_files(tmp_path, monkeypatch)
    real = env_mod.render_camera
    monkeypatch.setattr(env_mod, "render_camera",
                        lambda *a, **kw: (real(*a, **kw) * 0.9).clamp(0.0, 1.0))
    r = harness.measure(files, SEED, 0.3, False, device="cpu")
    assert r["gaps"]["image_mean"] > files["limits"]["image_mean"]
    assert not _correct(files, r)
    assert run.checks(files, r)[1] > 0


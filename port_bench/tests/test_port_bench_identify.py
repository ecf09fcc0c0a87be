"""The identification cell (``xyw_k4.identify``) at a toy size on the CPU:
its entry's own compared numbers pass a sound run and fail the controls,
its readers read a recorded trace and nothing without one, the fusion's
least bytes by hand, and the configuration's ``identify`` kept out of the
port's ``ExperimentConfig``."""

import importlib
import time

import pytest

from port_bench import drive, harness, run
from port_bench.entries import identification as entry

SEED = 3_100_000_029
READERS = ("seek_ms", "match_ms", "fuse_ms", "fuse_roofline")
# 3 objects, fingerprints of at most 20 capture steps, a 10-point grid and an
# 8-slot ring, adoption at the third tick
TOY_IDENT = dict(objects=3, capture_steps=20, grid=10, ring=8,
                 combos=[["L2", False], ["KL", False], ["BC", False], ["L2", True]],
                 seek_combo=0, seek_fingerprint=0, seek_mode="uncertain", sharpness=20.0,
                 adopt_step=3, update_every=1)


def _toy(**ident) -> dict:
    """The cell at ``toy.toy_mix``'s sizes (which finds a cell's traffic by
    the cell's name; this cell's traffic is ``identification``)."""
    files = harness.cell_files("xyw_k4.identify")
    files["config"].update(image_dim=[24, 24, 3], hidden_dim=[32, 16], num_target_samples=64,
                           num_traj_samples=50, traj_buffer_capacity=100, buffer_capacity=100,
                           batch_size=8, num_learning_opt=3, num_steps=90,
                           identify=dict(TOY_IDENT, **ident))
    files["traffic"].update(chunk=5, settle=2)
    files["traffic"]["compare"].update(within=16)
    return files


def _read(name, record):
    return importlib.import_module(f"port_bench.metrics.{name}").read(record)


def _fails(limits: dict, gaps: dict) -> list:
    return [k for k, lim in limits.items() if not gaps.get(k, float("inf")) <= lim]


@pytest.mark.parametrize("seek_mode", ["uncertain", "fixed"])
def test_a_sound_run_is_correct_and_each_control_is_not(seek_mode):
    """The program passes every limit of the cell, its own four numbers
    among them; the reference with the CVAE's products in float8, matching
    against half of each fingerprint's seeds, or leaving the state and the
    beliefs unchanged, fails the beliefs' or the distances' limits."""
    files = _toy(seek_mode=seek_mode)
    r = harness.measure(files, SEED, 0.5, False, device="cpu",
                        controls=("fp8", "half_batch", "stuck"))
    limits = files["limits"]
    assert {"belief", "belief_var", "dists", "seek"} <= set(limits)
    assert len(r["per_tick"]) == 4 and _fails(limits, r["gaps"]) == [], r["gaps"]
    assert r["captured_in_window"] == 0 and r["nonfinite"] == 0
    for name in ("fp8", "half_batch"):
        assert {"belief", "dists"} & set(_fails(limits, r["controls"][name])), name
    assert {"belief", "belief_var", "dists", "cost"} <= set(_fails(limits, r["controls"]["stuck"]))


def test_seeking_the_least_uncertain_object_is_caught(monkeypatch):
    """A planted fault in the program: the entropies negated, so the
    least uncertain object's belief is sought. ``seek`` reads 1."""
    from ealv_tpu_torch.fingerprint import test_runtime as trt

    real = trt._belief_entropies
    monkeypatch.setattr(trt, "_belief_entropies", lambda beliefs: -real(beliefs))
    files = _toy()
    r = harness.measure(files, SEED, 0.5, False, device="cpu")
    assert r["gaps"]["seek"] == 1.0 and "seek" in _fails(files["limits"], r["gaps"])


def test_each_reader_on_a_recorded_toy_trace():
    """``seek_ms``, ``match_ms`` and ``fuse_ms`` are their spans' device ms a
    tick; ``fuse_roofline`` the fusions' least time over ``fuse_ms``."""
    from ealv_tpu_torch.runtime import tracing

    tracing.enable("cpu")
    try:
        first, lo = tracing.ticks(), time.perf_counter_ns()
        for _ in range(4):
            with tracing.tick():
                tracing.begin("tick")
                for name in ("seek", "match", "fuse"):
                    tracing.begin(name)
                    time.sleep(2e-4)
                    tracing.end(name)
                tracing.end("tick")
        last, hi = tracing.ticks(), time.perf_counter_ns()
        tr = tracing.read(first, last)
    finally:
        tracing.disable()
    cfg = harness.load_json(harness.ROOT / "configs" / "xyw_k4.json")["config"]
    record = {"spans": tracing.summary(tr, lo, hi), "config": cfg}
    for name in ("seek", "match", "fuse"):
        spans = [s for s in tr.device if s.name == name]
        want = sum(s.ns for s in spans) / 1e6 / 4
        assert len(spans) == 4 and _read(f"{name}_ms", record) == pytest.approx(want, rel=1e-9)
    fuse = _read("fuse_ms", record)
    assert _read("fuse_roofline", record) == pytest.approx(
        32_000_000 / 3.35e12 * 1e3 / fuse * 100.0, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_finds_nothing_without_spans(name):
    cfg = harness.load_json(harness.ROOT / "configs" / "xyw_k4.json")["config"]
    assert _read(name, {"spans": None, "config": cfg}) is None
    # an eval cell's spans carry no identification span
    spans = {"device_ms": {"tick": 2.8, "decode": 0.25}, "ticks": 10}
    assert _read(name, {"spans": spans, "config": cfg}) is None


def test_the_fusions_least_bytes_by_hand():
    """Four combinations x four objects x 50^3 cells x (prior and variance,
    each read and written once, 4 bytes): 32,000,000 bytes, 9.55 us at
    3.35 TB/s."""
    fuse_roofline = importlib.import_module("port_bench.metrics.fuse_roofline")
    cfg = harness.load_json(harness.ROOT / "configs" / "xyw_k4.json")["config"]
    assert fuse_roofline.fusion_bytes(cfg) == 4 * 4 * 125_000 * 2 * 2 * 4 == 32_000_000
    spans = {"device_ms": {"fuse": 6.0}}
    assert fuse_roofline.read({"spans": spans, "config": cfg}) == pytest.approx(
        9.5522388e-3 / 6.0 * 100.0, rel=1e-6)
    # an eval cell's configuration has no identification
    assert fuse_roofline.read({"spans": spans, "config": {"states": "xyw"}}) is None


def test_the_entry_keeps_identify_out_of_the_ports_config(monkeypatch):
    """The configuration file's ``identify`` is the identification's; the
    port's ``ExperimentConfig`` refuses it, the entry takes it out first,
    and the run's record keeps the whole configuration for the readers."""
    files = _toy()
    with pytest.raises(TypeError):
        drive.program_config(files["config"])
    built = []
    real = drive.program_config
    monkeypatch.setattr(drive, "program_config", lambda cfg: built.append(cfg) or real(cfg))
    r = harness.measure(files, SEED, 0.2, False, device="cpu")
    assert built and all("identify" not in c for c in built)
    assert r["config"]["identify"] == files["config"]["identify"]
    cfg, ident = entry.split_config(files["config"])
    assert ident == TOY_IDENT and "identify" not in cfg and "identify" in files["config"]


def test_the_cell_is_in_the_manifest_with_its_readers():
    files = harness.cell_files("xyw_k4.identify")
    assert files["cell"]["chips"] == 1 and files["traffic"]["entry"] == "identification"
    names = [m["name"] for m in files["per_layer"]]
    assert set(READERS) <= set(names)
    assert set(files["limits"]) == {"cost", "image", "state", "start", "belief", "belief_var",
                                    "dists", "seek"}
    assert files["config"]["identify"]["grid"] ** len(files["config"]["states"]) == 125_000
    line = run.per_layer(files, {"spans": None, "config": files["config"], "host_s": [1e-3],
                                 "window_s": 1.0, "flops": 0, "traced": None, "gaps_s": [1e-2],
                                 "trained": [False]})
    assert not set(READERS) & set(line)

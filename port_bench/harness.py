"""One run of one cell: set-up, warm-up, the measured window, the traced
chunk, the comparison with the reference, and the result.

The window runs the traffic's entry in chunks of ``chunk`` ticks and reads
each chunk's infos back to the host at its end, as the port's run entry
does (``--chunk 25``). It opens on a synchronized device after the
warm-up and closes with the synchronize of its last chunk's read, whole
chunks until ``seconds`` have passed. A CUDA event recorded on the stream
after every tick call gives each tick's gap from the one before; there is
no host synchronisation inside a chunk, so a stall or a host lag shows in
the gaps.

A traced run (``trace_on``) turns the program's tracer
(``ealv_tpu_torch/runtime/tracing.py``) on before the entry is built, so
every graph it captures holds the tracer's stamps, and keeps the window's
spans as ``run["spans"]`` (``tracing.summary`` over the window's ticks and
its host-clock interval). An untraced run never turns it on.
"""

from __future__ import annotations

import gc
import json
import math
import random
import sys
import time
from pathlib import Path

import torch

from . import compare, counts, drive, trace
from .reference import cvae as ref_cvae

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BANNED = ("jax", "jaxlib", "flax", "ealv_tpu")


def banned_modules(names=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of ``BANNED``, compared whole: ``ealv_tpu_torch`` passes."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def process_age_s() -> float:
    """Seconds since this process started (Linux), at the clock tick's
    resolution."""
    import os
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of ``values`` do not exceed."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def load_json(path: Path):
    return json.loads(path.read_text())


def cell_files(name: str, manifest: dict | None = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and limits files, found by name."""
    manifest = manifest or load_json(REPO / "BENCHMARK.json")
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    per_layer = [m for m in manifest["per_layer"] if name in m.get("workloads", [name])]
    return dict(mix_files(REPO / conf["file"], cell["traffic"],
                          load_json(ROOT / "limits" / f"{name}.json")),
                cell=cell, end_to_end=manifest["end_to_end"], per_layer=per_layer)


def mix_files(config_file: Path, traffic: str, limits: dict) -> dict:
    """A configuration file under a traffic mix, held to ``limits``: what
    ``measure`` runs."""
    return dict(config=load_json(config_file)["config"],
                traffic=load_json(ROOT / "traffic" / f"{traffic}.json"), limits=limits)


class _Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, where
    every operation has ended when it returns, the host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()


def pick_ticks(seed: int, spec: dict, learning: bool) -> dict:
    """The compared ticks, drawn from the seed as ordinals among the
    window's first ``within`` ticks of each kind: {"train": {...},
    "explore": {...}}."""
    rng = random.Random(seed)
    n_train = spec["trained"] if learning else 0
    return {"train": set(rng.sample(range(spec["within"] // 4), n_train)),
            "explore": set(rng.sample(range(spec["within"] // 2), spec["ticks"] - n_train))}


def warm(drv, settle: int, limit: int = 200) -> int:
    """Tick until ``settle`` ticks in a row captured and warmed up no
    graph. Returns the ticks made."""
    quiet = n = 0
    while quiet < settle:
        before = drv.settled_count()
        drv.tick()
        n += 1
        quiet = quiet + 1 if drv.settled_count() == before else 0
        if n >= limit:
            raise RuntimeError(f"the tick graph still captures after {n} warm ticks")
    return n


def _read_chunk(drv, infos) -> int:
    """Read a chunk's infos to the host; the number of ticks with a value
    that is not finite."""
    vals = torch.stack([torch.stack([i[k].float().reshape(()) for k in drv.checked])
                        for i in infos]).cpu()
    return int((~torch.isfinite(vals)).any(1).sum())


def window(drv, seconds: float, chunk: int, picks: dict, max_ticks: int, clock: _Clock) -> dict:
    """The measured window. Returns its ticks, each tick's gap and host
    seconds and whether it trained, its seconds, the ticks whose infos were
    not finite, and the compared ticks' (snapshot, outputs)."""
    gaps, host, trained, compared = [], [], [], []
    seen = {"train": 0, "explore": 0}
    nonfinite = 0
    clock.sync()
    t0 = time.perf_counter()
    last = clock.mark()
    while True:
        infos = []
        for _ in range(chunk):
            kind = "train" if drv.will_train() else "explore"
            snap = drv.snapshot() if seen[kind] in picks[kind] else None
            seen[kind] += 1
            h0 = time.perf_counter()
            info = drv.tick()
            host.append(time.perf_counter() - h0)
            mark = clock.mark()
            gaps.append((last, mark))
            last = mark
            trained.append(drv.trained)
            infos.append(info)
            if snap is not None:
                compared.append((snap, drv.outputs(snap, info)))
        nonfinite += _read_chunk(drv, infos)
        clock.sync()
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds or len(gaps) + chunk > max_ticks:
            break
    return dict(ticks=len(gaps), window_s=elapsed, opened_s=t0, trained=trained, host_s=host,
                gaps_s=[clock.seconds(a, b) for a, b in gaps], nonfinite=nonfinite,
                compared=compared)


def traced_chunk(drv, chunk: int, clock: _Clock) -> dict:
    """One more chunk under ``torch.profiler``: the device's busy time,
    K1's device time and least time (``drv.k1_launches``), the device work
    by name (``by_name``, all of it; ``device_ops``, the longest 10), the
    longest idle gaps, the history's fill before the chunk (``fill0``) and
    its ticks. The profiler's tracing of every kernel slows the chunk
    (PERF.md, Layers), so its busy share is not the window's."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    fill0 = drv.fill()  # each tick pushes one point to the history first
    bound = sum(counts.k1_bound_s(*launch)[0] for i in range(chunk)
                for launch in drv.k1_launches(fill0 + i + 1))
    clock.sync()
    with torch.profiler.profile(activities=acts) as prof:
        infos = []
        with torch.profiler.record_function(trace.HOST_PREFIX + "chunk"):
            for _ in range(chunk):
                with torch.profiler.record_function(trace.HOST_PREFIX + "tick"):
                    infos.append(drv.tick())
            with torch.profiler.record_function(trace.HOST_PREFIX + "readback"):
                _read_chunk(drv, infos)
        clock.sync()
    device, host = trace.events(prof)
    span = next(s for s in host if s[0] == "chunk")
    lo, hi = span[1], span[2]
    names = trace.by_name(device, lo, hi)
    k1 = sum(s for n, s in names.items() if "footprint" in n)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(hi - lo) / 1e9, busy_s=trace.busy_ns(device, lo, hi) / 1e9,
                k1_s=k1, k1_bound_s=bound, device_ops=[[n, s] for n, s in top],
                idle_gaps=trace.idle_gaps(device, host, lo, hi), by_name=names,
                fill0=fill0, ticks=chunk)


CONTROLS = {"fp8": dict(cast=ref_cvae.fp8_round, ring_cast=ref_cvae.fp8_round),
            "f32": dict(cast=ref_cvae.no_cast, ring_cast=ref_cvae.no_cast),
            "half_batch": dict(half_batch=True), "stuck": dict(stuck=True)}


def reference_gaps(drv, compared: list, ring_y, controls=()) -> tuple:
    """The compared ticks recomputed by the reference: (the program's gaps
    a tick, {control: its gaps a tick}). A control is the reference in
    the program's place: with the CVAE's products and the ring's images in
    another precision (``CONTROLS``: ``fp8``, the precision below the
    configuration's, the control proper; ``f32``, a witness above it) or
    with a planted fault (``half_batch``; ``stuck``, a tick that returns
    its state unchanged). Each follows the program's plan after the
    planner, as the reference does. The entry's own numbers
    (``drv.extra_gaps``) join each tick's gaps, the controls' alike."""
    ref = drv.reference()
    target = drv.target(ref)
    others = {}
    for name in controls:
        tick = drv.reference(**CONTROLS[name])
        others[name] = (tick, drv.target(tick))
    prog_gaps, ctl_gaps = [], {name: [] for name in controls}
    for snap, prog in compared:
        if ring_y is not None:
            prog["image"] = ring_y[int(snap["ring_pos"])]
        r = drv.recompute(ref, target, snap, ring_y, prog["u"])
        prog_gaps.append({**compare.tick_gaps(prog, r, snap), **drv.extra_gaps(prog, r, snap)})
        for name, (tick, tgt) in others.items():
            c = drv.recompute(tick, tgt, snap, ring_y, prog["u"])
            c["trained"] = prog["trained"] and "losses" in c
            if "losses" in c:
                c["loss"] = c["losses"][-1]
            ctl_gaps[name].append({**compare.tick_gaps(c, r, snap), **drv.extra_gaps(c, r, snap)})
    return prog_gaps, ctl_gaps


def measure(files: dict, seed: int, seconds: float, trace_on: bool, device="cuda",
            controls=()) -> dict:
    """One run of a cell from its ``cell_files``. Returns the result's
    fields (and, with ``controls``, their gaps beside the program's)."""
    from ealv_tpu_torch.runtime import tracing
    cfg, traffic = files["config"], files["traffic"]
    clock = _Clock(device)
    if trace_on:
        tracing.enable(device)
    drv = drive.make(cfg, traffic, seed, device)
    n_warm = warm(drv, traffic["settle"])
    clock.sync()
    settled = drv.settled_count()
    setup_s = process_age_s()
    picks = pick_ticks(seed, traffic["compare"], drv.learning)
    max_ticks = cfg["num_steps"] - n_warm - (traffic["chunk"] if trace_on else 0)
    first = tracing.ticks() if trace_on else None
    win = window(drv, seconds, traffic["chunk"], picks, max_ticks, clock)
    captured_in_window = drv.settled_count() - settled
    spans = traced = None
    if trace_on:
        lo = round(win["opened_s"] * 1e9)  # perf_counter's clock, the tracer's host clock
        spans = tracing.summary(tracing.read(first, tracing.ticks()), lo,
                                lo + round(win["window_s"] * 1e9))
        traced = traced_chunk(drv, traffic["chunk"], clock)
        tracing.disable()
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0
    ring_y = drv.ring_images()
    compared = win.pop("compared")
    drv.free()
    gc.collect()
    if clock.cuda:
        torch.cuda.empty_cache()
    prog_gaps, ctl_gaps = reference_gaps(drv, compared, ring_y, controls)
    gaps = dict(compare.widest(prog_gaps), start=drv.start_gap(drv.reference()))
    flops = sum(drv.tick_flops(t) for t in win["trained"])
    return dict(setup_s=setup_s, warm_ticks=n_warm, captured_in_window=captured_in_window,
                memory_peak_bytes=peak, traced=traced, spans=spans, config=cfg, flops=flops,
                gaps=gaps, per_tick=prog_gaps,
                controls={k: compare.widest(v) for k, v in ctl_gaps.items()},
                controls_per_tick=ctl_gaps, learning=drv.learning, **win)

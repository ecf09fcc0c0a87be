"""The tracer: spans inside the port's tick, on the host and on the card,
put on one clock.

Off by default, and off means absent: ``span`` and ``tick`` return one
shared null context, ``begin`` and ``end`` return at once, and no stamp
kernel is built, loaded or captured. ``enable(device)`` turns it on for the
process, ``disable()`` off.

Host spans. ``span(name)`` records the name, the tick it runs in, the span
that encloses it, and its start and end on ``time.perf_counter_ns``. The
runtimes open ``tick`` around ``Experiment.tick``, ``EvalExperiment.tick``,
the identification tick (``fingerprint/test_runtime.py``) and
``HostLoopRunner.step`` (``tick()``, which also numbers the ticks);
``runtime/graphs.py`` ``StepGraph.step`` opens ``key``, ``stage``,
``replay`` and ``clone`` inside it, and the host loop ``watchdog`` around
its stuck check (the wait for the watchdog slice's copy, the check and any
escape). While a ``torch.profiler`` runs, a span
also opens ``record_function("ealv." + name)``, so the profiler's trace
carries it on the profiler's clock.

Device stamps. ``begin(name)`` and ``end(name)``, inside a tick, launch a
one-thread kernel (``csrc/stamp.cu``) that writes the card's
``%globaltimer`` to ``ring[tick % CAPACITY, point]``, a device buffer the
tracer owns; each (name, edge, occurrence within the tick) takes a point
of its own the first time it is stamped. A CUDA event captured in a graph
is one event on every replay, but a stamp reads the tick counter through a
pointer, so each replay writes its own tick's row. ``tick()`` launches the
counter's advance after the tick, so the device's tick ids and the host's
move together whether the tick ran eagerly, captured or replayed. Outside a
tick ``begin`` and ``end`` do nothing, but inside ``ahead()``, around a
step captured ahead of its first tick, which records them. On the CPU a stamp takes the host
clock. The device spans: ``tick``, from the tick body's first kernel to its
last, and inside it ``decode`` and ``descent`` (``control/klerg.py``),
``env`` (``agent.py``, ``tester.py``), ``absorb``, ``train`` and
``grade`` (``agent.py``: the trainer call is made inside ``absorb_step``,
so ``train`` lies inside ``absorb``; ``grade``, the entropy grade's fresh
decode and coverage spread before a call that does not fold the planner's
decode, lies there too), in an identification tick
``seek``, ``match`` and ``fuse`` (``fingerprint/test_runtime.py``), and in
a host-loop step (``runtime/host_loop.py``, whose ``tick`` spans the whole
step) ``arm``, the bridge's command and observation on the card; there
``env`` spans only the command's conversion, the arm's work being ``arm``.

Host counters. ``count(name, n=1)`` adds ``n`` to the counter ``name`` of
the tick it runs in (outside every tick, to the run's): events a tick
makes on the host, such as the host loop's plan primed from a host
observation (``prime``), stuck hit (``stuck``), escape (``escape``), drift
correction (``drift``) and recovery (``recover``) in
``runtime/host_loop.py``. Off, it returns at once and keeps nothing.

One clock. ``read()`` drains the records and maps the stamps onto the host
clock by the tightest of a few calibration pairs (host clock, stamp,
synchronize, host clock): the offset, and half the pair's round trip as its
uncertainty. The card's timer and the host's clock drift apart by a few
parts in a million, tens of us over a run, so the map is the line through
this calibration and the one before (at ``enable`` or the last read) where
they lie a second or more apart. ``summary`` gives each span's self time a
tick and the share of a window in which no tick's device span was open,
each such gap put down to the innermost host span over its midpoint (or
"outside").

A captured graph holds the stamps' points and the buffers' addresses, so
``state()`` is part of the key of every step graph
(``runtime/graphs.py``): toggling the tracer drops their graphs, and they
capture anew.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import dataclasses
import functools
import time

import torch

CAPACITY = 4096  # ticks the device ring holds: a whole run of the benchmark
POINTS = 32  # stamps a tick may take

_NULL = contextlib.nullcontext()
_tracer = None  # the process's _Tracer while tracing is on
_generation = 0  # enables so far: a graph key never matches a graph of another


@dataclasses.dataclass(frozen=True)
class Span:
    name: str
    tick: int | None  # the tick it ran in; None outside every tick
    parent: int | None  # the enclosing span's index in the same list
    start_ns: int  # on time.perf_counter_ns
    end_ns: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Trace:
    """What ``read()`` drained: the host spans and the device spans of the
    ticks read, the device spans mapped onto the host clock."""

    ticks: range
    host: list
    device: list
    offset_ns: int  # host clock = stamp + offset_ns, at the read
    uncertainty_ns: int  # half the calibration pair's round trip
    drift_ns: int  # offset_ns less the previous calibration's (at enable or the last read)
    lost: int  # ticks read whose stamps the ring had already overwritten
    counts: dict = dataclasses.field(default_factory=dict)  # {name: {tick or None: n}}


@functools.cache
def _library():
    from ..ops import cuda_build
    lib = cuda_build.load("stamp.cu")
    lib.ealv_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.ealv_stamp.restype = ctypes.c_int
    lib.ealv_advance.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ealv_advance.restype = ctypes.c_int
    return lib


def _checked(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


class _Tracer:
    def __init__(self, device, generation: int):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.generation = generation
        self.ring = torch.zeros((CAPACITY, POINTS), dtype=torch.int64, device=self.device)
        self.ticks = 0  # ticks begun, which the device counter holds between ticks
        self.first = 0  # the first tick not yet read
        self.current = None  # the open tick's id
        self.points: dict = {}  # (name, edge, occurrence) -> the ring's column
        self.seen: dict = {}  # (name, edge) -> its stamps so far in the open tick
        self.spans: list = []  # host spans: [name, tick, parent, start, end]
        self.counts: dict = {}  # (name, tick or None) -> n
        self.open: list = []  # the open host spans' indices
        if self.cuda:
            self.lib = _library()
            self.counter = torch.zeros((), dtype=torch.int64, device=self.device)
            self.calib = torch.zeros(2, dtype=torch.int64, device=self.device)  # [0, stamp]
        self.calibration = self._calibrate()

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.device).cuda_stream

    def _calibrate(self) -> tuple:
        """(host clock, stamp, uncertainty) in ns: the tightest of five
        pairs of host clock, stamp, synchronize, host clock, its stamp
        against the pair's midpoint."""
        if not self.cuda:
            return 0, 0, 0
        best = None
        for _ in range(5):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            _checked(self.lib.ealv_stamp(self.calib[1:].data_ptr(), self.calib.data_ptr(), 1, 1,
                                         0, 0, self._stream()), "stamp")
            torch.cuda.synchronize(self.device)
            h1 = time.perf_counter_ns()
            if best is None or h1 - h0 < best[2] * 2:
                best = ((h0 + h1) // 2, int(self.calib[1]), (h1 - h0) // 2)
        return best

    @contextlib.contextmanager
    def span(self, name: str):
        record = [name, self.current, self.open[-1] if self.open else None,
                  time.perf_counter_ns(), None]
        self.open.append(len(self.spans))
        self.spans.append(record)
        try:
            if torch._C._autograd._profiler_enabled():
                with torch.profiler.record_function("ealv." + name):
                    yield
            else:
                yield
        finally:
            record[4] = time.perf_counter_ns()
            self.open.pop()

    @contextlib.contextmanager
    def tick(self):
        if self.current is not None:
            raise RuntimeError("a tick opened inside another tick")
        self.current, self.seen = self.ticks, {}
        try:
            with self.span("tick"):
                yield
        finally:
            self.current = None
            self.ticks += 1
            if self.cuda:
                _checked(self.lib.ealv_advance(self.counter.data_ptr(), self._stream()),
                         "advance")

    @contextlib.contextmanager
    def ahead(self):
        if self.current is not None:
            raise RuntimeError("a capture ahead opened inside a tick")
        # the tick id the stamps would take: only checked against None, since
        # a captured stamp reads the tick counter when the graph replays
        self.current, self.seen = self.ticks, {}
        try:
            yield
        finally:
            self.current = None

    def count(self, name: str, n: int) -> None:
        key = (name, self.current)
        self.counts[key] = self.counts.get(key, 0) + n

    def stamp(self, name: str, edge: int) -> None:
        if self.current is None:
            return
        n = self.seen.get((name, edge), 0)
        self.seen[(name, edge)] = n + 1
        point = self.points.setdefault((name, edge, n), len(self.points))
        if point >= POINTS:
            raise RuntimeError(f"a tick takes at most {POINTS} stamps: no point left for "
                               f"{name!r} ({n + 1} in one tick)")
        clear = len(self.seen) == 1 and n == 0  # the tick's first stamp clears its row
        if self.cuda:
            _checked(self.lib.ealv_stamp(self.ring.data_ptr(), self.counter.data_ptr(), CAPACITY,
                                         POINTS, point, int(clear), self._stream()), "stamp")
        else:
            row = self.ring[self.current % CAPACITY]
            if clear:
                row.zero_()
            row[point] = time.perf_counter_ns()

    def read(self, first=None, last=None) -> Trace:
        if self.open:
            raise RuntimeError("read() inside an open span")
        window = first is not None or last is not None
        first = self.first if first is None else first
        last = self.ticks if last is None else last
        (h0, g0, _), (h1, g1, uncertainty) = self.calibration, self._calibrate()
        rate = (h1 - h0) / (g1 - g0) if h1 - h0 >= 1_000_000_000 else 1.0
        rows = self.ring.cpu()
        oldest = max(first, self.ticks - CAPACITY)
        device = []
        for t in range(oldest, last):
            row = rows[t % CAPACITY].tolist()
            edges: dict = {}
            for (name, edge, n), point in self.points.items():
                if row[point]:
                    host = h1 + round((row[point] - g1) * rate)
                    edges.setdefault((name, n), [None, None])[edge] = host
            found = sorted((b, -e, name) for (name, _), (b, e) in edges.items()
                           if b is not None and e is not None)
            device += _nest([(name, t, b, -e) for b, e, name in found], len(device))
        keep = {}
        for i, (name, tick, parent, start, end) in enumerate(self.spans):
            if (first <= tick < last) if tick is not None else not window:
                keep[i] = Span(name, tick, parent, start, end)
        renumber = {old: new for new, old in enumerate(keep)}
        host = [dataclasses.replace(s, parent=renumber.get(s.parent)) for s in keep.values()]
        counts: dict = {}
        for (name, tick), n in self.counts.items():
            if (first <= tick < last) if tick is not None else not window:
                counts.setdefault(name, {})[tick] = n
        trace = Trace(ticks=range(first, last), host=host, device=device, offset_ns=h1 - g1,
                      uncertainty_ns=uncertainty, drift_ns=(h1 - g1) - (h0 - g0),
                      lost=max(0, oldest - first), counts=counts)
        self.spans, self.counts = [], {}
        self.first, self.calibration = self.ticks, (h1, g1, uncertainty)
        return trace


def _nest(spans, base: int) -> list:
    """``Span``s of one tick from [(name, tick, start, end)] sorted by start
    and then by end, latest first: each span's parent is the innermost one
    that contains it; indices count from ``base``."""
    out, stack = [], []
    for name, tick, start, end in spans:
        while stack and out[stack[-1] - base].end_ns < end:
            stack.pop()
        out.append(Span(name, tick, stack[-1] if stack else None, start, end))
        stack.append(base + len(out) - 1)
    return out


def enable(device="cuda") -> None:
    """Turn the tracer on for the process, its buffers on ``device`` (and,
    on the card, its stamp kernel built and loaded). Every step graph
    captures anew at its next step."""
    global _tracer, _generation
    _generation += 1
    _tracer = _Tracer(device, _generation)


def disable() -> None:
    """Turn the tracer off; what it held is dropped."""
    global _tracer
    _tracer = None


def state():
    """The tracer's part of a graph's key: None while off, else which
    ``enable`` it is."""
    return None if _tracer is None else _tracer.generation


def ticks() -> int:
    """Ticks begun since the tracer was turned on: the id the next tick
    takes."""
    return _tracer.ticks


def span(name: str):
    """A host span ``name`` as a context manager."""
    return _NULL if _tracer is None else _tracer.span(name)


def tick():
    """The host span ``tick``, which numbers the ticks (see the module's
    docstring)."""
    return _NULL if _tracer is None else _tracer.tick()


def ahead():
    """Around a step captured ahead of the tick that first replays it
    (``Experiment.tick``'s drift twins), outside every tick: its stamps
    take their points as a tick's do, and no tick is counted."""
    return _NULL if _tracer is None else _tracer.ahead()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` of the open tick."""
    if _tracer is not None:
        _tracer.count(name, n)


def begin(name: str) -> None:
    """Stamp the start of the device span ``name``."""
    if _tracer is not None:
        _tracer.stamp(name, 0)


def end(name: str) -> None:
    """Stamp the end of the device span ``name``."""
    if _tracer is not None:
        _tracer.stamp(name, 1)


def read(first=None, last=None) -> Trace:
    """Drain the records: the spans of ticks ``first`` to ``last`` (not
    included). By default every tick since the last read, with the host
    spans outside every tick; with a window, only the window's ticks. What
    was recorded before is forgotten either way."""
    return _tracer.read(first, last)


def _union_ns(intervals, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    total, reach = 0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def self_ns(spans: list) -> list:
    """Each span's duration less the part of it that its children cover."""
    children: dict = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    return [s.ns - _union_ns(children.get(i, ()), s.start_ns, s.end_ns)
            for i, s in enumerate(spans)]


def summary(trace: Trace, lo=None, hi=None) -> dict:
    """Per tick of ``trace``: each host and device span's self time and
    each device span's duration (ms, means a tick), the device spans'
    count; each host counter's sum over the trace (``counts``); and over
    [lo, hi] on the host clock (by default the first host ``tick`` span's
    start to the last tick's end on either side), the share in which no
    tick's device span was open, those gaps in ms a tick by the innermost
    host span over each gap's midpoint ("outside" where none)."""
    n = max(1, len(trace.ticks))
    ticks = [s for s in trace.device if s.name == "tick"]
    host_ticks = [s for s in trace.host if s.name == "tick"]
    if lo is None:
        lo = min((s.start_ns for s in host_ticks + ticks), default=0)
    if hi is None:
        hi = max((s.end_ns for s in host_ticks + ticks), default=lo)
    out = {"ticks": len(trace.ticks), "host_self_ms": {}, "device_ms": {},
           "device_self_ms": {}, "device_calls": {}, "wait_ms": {},
           "counts": {name: sum(by_tick.values()) for name, by_tick in trace.counts.items()}}
    for kind, spans in (("host_self_ms", trace.host), ("device_self_ms", trace.device)):
        for s, ns in zip(spans, self_ns(spans)):
            out[kind][s.name] = out[kind].get(s.name, 0.0) + ns / 1e6 / n
    for s in trace.device:
        out["device_ms"][s.name] = out["device_ms"].get(s.name, 0.0) + s.ns / 1e6 / n
        out["device_calls"][s.name] = out["device_calls"].get(s.name, 0) + 1
    host = sorted(trace.host, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in host]
    longest = max((s.ns for s in host), default=0)
    edges = [lo] + [x for s in sorted(ticks, key=lambda s: s.start_ns)
                    for x in (max(lo, s.start_ns), min(hi, s.end_ns))] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        near = host[bisect.bisect_left(starts, mid - longest):bisect.bisect_right(starts, mid)]
        over = [(s.ns, s.name) for s in near if s.end_ns >= mid]
        name = min(over)[1] if over else "outside"
        out["wait_ms"][name] = out["wait_ms"].get(name, 0.0) + (b - a) / 1e6 / n
    window = hi - lo
    busy = _union_ns([(s.start_ns, s.end_ns) for s in ticks], lo, hi)
    out["device_wait_pct"] = (window - busy) / window * 100.0 if window > 0 else None
    return out


def describe(s: dict) -> str:
    """``summary``'s numbers as lines for a run's log."""
    ms = lambda d: ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items(), key=lambda kv: -kv[1]))
    wait = s["device_wait_pct"]
    lines = [
        f"tracer: {s['ticks']} ticks; host self ms a tick: {ms(s['host_self_ms'])}",
        f"tracer: device ms a tick: {ms(s['device_ms'])}; self: {ms(s['device_self_ms'])}",
        "tracer: device wait " + ("not measured" if wait is None else f"{wait:.2f}%")
        + f" of the window, ms a tick by host span: {ms(s['wait_ms'])}"]
    if s["counts"]:
        lines.append("tracer: counts: " + ", ".join(f"{k} {v}" for k, v in
                                                    sorted(s["counts"].items())))
    return "\n".join(lines)

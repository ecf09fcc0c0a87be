"""Reading a ``torch.profiler`` trace of the card: the device's work as
intervals, its busy time as their union, the idle gaps between them named
by what the host was doing, and the kernel time by name.

The device's work is every event on the card that is not a user
annotation: kernels, copies and sets, those a graph replay launches
included. The host's spans are the ``record_function`` ranges the harness
opens around its own calls (``port_bench.*``, named without the prefix)
and those the program's tracer opens around its own spans while a
profiler runs (``ealv.*``, named with it, so that the program's ``tick``
and the harness's stay apart).
"""

from __future__ import annotations

HOST_PREFIX = "port_bench."
PROGRAM_PREFIX = "ealv."


def events(prof) -> tuple:
    """(device [(name, start_ns, end_ns)], host spans [(name, start_ns,
    end_ns)]) of a finished profiler."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        if kind.endswith("CPU"):
            name = e.name()
            if e.is_user_annotation() and name.startswith((HOST_PREFIX, PROGRAM_PREFIX)):
                host.append((name.removeprefix(HOST_PREFIX), e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            device.append((e.name(), e.start_ns(), e.end_ns()))
    return device, host


def merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_ns(device, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that the union of the device's work covers."""
    clipped = [(max(a, lo), min(b, hi)) for _, a, b in device if b > lo and a < hi]
    return sum(b - a for a, b in merge(clipped))


def idle_gaps(device, host, lo: int, hi: int, top: int = 10) -> list:
    """The ``top`` longest stretches of [lo, hi] with no device work, each
    named by the innermost host span, the harness's or the program's, that
    covers its midpoint ("harness" where none does): [[name, seconds],
    ...], longest first."""
    busy = merge((max(a, lo), min(b, hi)) for _, a, b in device if b > lo and a < hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        inside = [(s1 - s0, name) for name, s0, s1 in host if s0 <= mid <= s1]
        out.append([min(inside)[1] if inside else "harness", (b - a) / 1e9])
    return out


def by_name(device, lo: int, hi: int) -> dict:
    """Seconds of device work by name inside [lo, hi]."""
    out = {}
    for name, a, b in device:
        if b > lo and a < hi:
            out[name] = out.get(name, 0.0) + (min(b, hi) - max(a, lo)) / 1e9
    return out

"""Host milliseconds a tick spends in the program's tick entry outside the
replay's launch, the mean over the window's ticks: the tracer's host span
``tick`` less ``replay`` (its base key, the staging copies, the clones
out and the tick's own host work), the sum of the host spans' self times
but the replay's (``run["spans"]``, ``tracing.summary``)."""


def read(run):
    spans = run.get("spans")
    if not spans or "tick" not in spans["host_self_ms"]:
        return None
    return sum(ms for name, ms in spans["host_self_ms"].items() if name != "replay")

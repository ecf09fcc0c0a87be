"""Device milliseconds of the tracer's span ``decode`` a tick, the mean over
the window's ticks: ``KlergPlanner.plan`` from its top to the descent, the
draws, the target decode and the base footprint (``run["spans"]``, its
stamps on the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("decode") if spans else None

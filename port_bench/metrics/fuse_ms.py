"""Device milliseconds of the tracer's span ``fuse`` a tick, the mean over
the window's ticks: the identification's relative poses, the pushes into
the beliefs' rings and the fusion of every combination's and object's
belief (``run["spans"]``, its stamps on the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("fuse") if spans else None

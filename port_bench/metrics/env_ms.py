"""Device milliseconds of the tracer's span ``env`` a tick, the mean over
the window's ticks: the command, the env's steps, ``observe`` and the
render (``run["spans"]``, its stamps on the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("env") if spans else None

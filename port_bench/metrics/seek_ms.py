"""Device milliseconds of the tracer's span ``seek`` a tick, the mean over
the window's ticks: the identification's pick of the belief to seek, each
object's belief entropy and the device-side selection of the largest
(``run["spans"]``, its stamps on the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("seek") if spans else None

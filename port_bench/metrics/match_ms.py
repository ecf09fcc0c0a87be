"""Device milliseconds of the tracer's span ``match`` a tick, the mean
over the window's ticks: the identification's eval-mode CVAE forward of
the tick's image at the K*S stored seed poses and every combination's
distances and best seeds (``run["spans"]``, its stamps on the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("match") if spans else None

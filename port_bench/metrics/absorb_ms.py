"""Device milliseconds of the tracer's span ``absorb`` a tick, its self
time (the trainer calls' ``train`` spans inside it left out), the mean
over the window's ticks: the ring's push, ``update_dist``, the grade and
the hyperparameters (``run["spans"]``, its stamps on the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_self_ms"].get("absorb") if spans else None

"""Device milliseconds of the tracer's span ``descent`` a tick, the mean
over the window's ticks: the planner's ``num_iters`` loop, its line
search, rollouts, costate sweeps and KL (``run["spans"]``, its stamps on
the card)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("descent") if spans else None

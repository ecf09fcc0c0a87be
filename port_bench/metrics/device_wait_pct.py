"""The share of the window, in %, in which no tick's device span was open:
the card waiting for the host, the chunks' reads included
(``tracing.summary``'s ``device_wait_pct`` over the window's host-clock
interval, the tracer's stamps mapped onto that clock; ``run["spans"]``)."""


def read(run):
    spans = run.get("spans")
    return spans["device_wait_pct"] if spans else None

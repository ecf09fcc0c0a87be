"""Host milliseconds of the tracer's span ``watchdog`` a step, its self
time, the mean over the window's steps: the host loop's wait for the
previous step's watchdog slice to reach pinned host memory, the stuck
check and any escape command (``run["spans"]``)."""


def read(run):
    spans = run.get("spans")
    return spans["host_self_ms"].get("watchdog") if spans else None

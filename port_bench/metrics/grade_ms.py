"""Device milliseconds of one entropy grade that does not fold the
planner's decode, the mean over the window's trainer calls: the tracer's
span ``grade`` (``Experiment._grade_spread``: the uniform draws, the fresh
2000-sample decode and the coverage spread over the ring's poses;
``run["spans"]``, its stamps on the card) over its count. Nothing to read
where no call of the window graded afresh, or the program has no such
span."""


def read(run):
    spans = run.get("spans")
    if not spans or not spans["device_calls"].get("grade"):
        return None
    return spans["device_ms"]["grade"] * spans["ticks"] / spans["device_calls"]["grade"]

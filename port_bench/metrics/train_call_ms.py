"""Device milliseconds of one trainer call, the mean over the window's
calls: the tracer's span ``train`` (``run["spans"]``, its stamps on the
card) over its count. Nothing to read where no tick of the window
trained."""


def read(run):
    spans = run.get("spans")
    if not spans or not spans["device_calls"].get("train"):
        return None
    return spans["device_ms"]["train"] * spans["ticks"] / spans["device_calls"]["train"]

"""Device milliseconds of the tracer's span ``arm`` a step, the mean over
the window's steps: the host loop's command and observation on the card
(the bridge's ``cmd_observe_pure``: the contact guard, 4 damped
pseudo-inverse substeps, the drift correction's IK every 20th command, the
contact force and the camera's render; ``run["spans"]``)."""


def read(run):
    spans = run.get("spans")
    return spans["device_ms"].get("arm") if spans else None

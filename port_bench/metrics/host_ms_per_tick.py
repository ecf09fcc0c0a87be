"""Host milliseconds a tick call takes to return, the mean over the
window: the replay's enqueue, the staging of host values, the keys and
the clones of its outputs (the benchmark's own host-clock span around
each call of the entry)."""


def read(run):
    return sum(run["host_s"]) / len(run["host_s"]) * 1e3

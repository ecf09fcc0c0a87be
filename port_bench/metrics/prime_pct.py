"""The share of the window's steps, in %, that primed a plan from a host
observation (the tracer's counter ``prime``: the first step, or one after
a stuck hit dropped the pipelined plan), which then replay the plan graph
before the step graph. None where the program keeps no counters."""


def read(run):
    spans = run.get("spans")
    if not spans or "counts" not in spans or not spans["ticks"]:
        return None
    return spans["counts"].get("prime", 0) / spans["ticks"] * 100.0

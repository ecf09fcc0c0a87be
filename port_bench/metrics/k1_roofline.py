"""K1's share of its roofline in the traced chunk, in %: the least time
of its launches (``counts.k1_bound_s`` on the unmasked points each launch
has, the planner history's fill at each tick) over their device time in
the profiler (kernels named ``footprint*``)."""


def read(run):
    t = run["traced"]
    if not t or t["k1_s"] <= 0:
        return None
    return t["k1_bound_s"] / t["k1_s"] * 100.0

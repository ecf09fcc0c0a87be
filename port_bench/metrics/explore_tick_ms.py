"""Mean event gap of a learning cell's ticks that make no trainer call,
in ms: planner, env, render and ring alone. Nothing to read where no tick
of the window trained."""


def read(run):
    if not any(run["trained"]):
        return None
    gaps = [g for g, t in zip(run["gaps_s"], run["trained"]) if not t]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None

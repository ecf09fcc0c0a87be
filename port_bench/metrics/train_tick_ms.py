"""Mean event gap of the window's ticks that make a trainer call, in ms:
the trainer's device time plus the rest of such a tick. Which ticks those
are comes from the throttle's host counters."""


def read(run):
    gaps = [g for g, t in zip(run["gaps_s"], run["trained"]) if t]
    return sum(gaps) / len(gaps) * 1e3 if gaps else None

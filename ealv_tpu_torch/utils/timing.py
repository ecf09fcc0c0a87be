"""Timing of work on the card: device time from CUDA events and the host
clock a caller pays. Both need a CUDA device; nothing here runs at import
time."""

from __future__ import annotations

import time

import numpy as np
import torch


def host_ms(fn, inner: int = 50) -> float:
    """Host clock per call of ``inner`` back-to-back calls ending in a
    synchronize, after 5 warm calls: what a caller that launches the work
    and nothing else pays."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / inner * 1e3


def device_ms(fn, reps: int = 21, inner: int = 50) -> float:
    """Device time per call: median over ``reps`` of the mean time of
    ``inner`` back-to-back calls, from CUDA events. A spin kernel holds the
    stream while the host enqueues the calls, so the host's per-call
    overhead does not pace the device."""
    host = host_ms(fn, inner)
    spin = int(2e9 * 2 * host * 1e-3 * inner)  # twice the loop, at <= 2 GHz
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))

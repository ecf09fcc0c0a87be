"""Fixed trajectory generators for test-set capture and goal seeking: a
numpy-only copy of ``ealv_tpu/utils/trajectories.py``."""

from __future__ import annotations

import numpy as np


def circular_traj(radius: float = 0.25, num_points: int = 10, center=(0.0, 0.0),
                  start: int | None = None, rng=None):
    """Points on a circle, starting at a random (or given) index."""
    center = np.asarray(center, np.float32)
    if start is None:
        rng = rng or np.random.default_rng()
        start = int(rng.integers(num_points))
    step = 2 * np.pi / num_points
    angles = (start + np.arange(num_points)) * step
    return center[None, :] + radius * np.stack(
        [np.cos(angles), np.sin(angles)], axis=1).astype(np.float32)


def grid_traj(grid_size: float = 0.1, num_points: int = 10, center=(0.0, 0.0)):
    """Boustrophedon (serpentine) grid sweep centred on ``center``."""
    center = np.asarray(center, np.float32)
    mul = int(np.round(np.sqrt(num_points)))
    x = np.linspace(-1, 1, mul)
    y = np.linspace(-1, 1, mul)
    xx, yy = np.meshgrid(x, y)
    xx = xx * grid_size / 2 + center[0]
    yy = yy * grid_size / 2 + center[1]
    xx[::2] = np.fliplr(xx[::2])  # flip even rows -> connected path
    return np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float32)

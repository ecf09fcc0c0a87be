"""Online clustering monitor (port of ``ealv_tpu/fingerprint/monitor.py``):
re-cluster the live model's uncertainty field now and then, compare with
the previous clusters by the permutation-minimal mean squared error, call
the clusters stable under ``stable_thresh`` (and checkpoint then), and keep
a CSV log of the passes. The monitor reads the model it holds, whose
parameters are the live ones."""

from __future__ import annotations

import csv
import itertools
import os
from dataclasses import dataclass, field

import numpy as np

from .clustering import find_clusters


def cluster_stability_error(means_a, means_b):
    """Least mean squared error between two cluster sets over the
    permutations of the second; inf when the counts differ or are zero."""
    means_a, means_b = np.asarray(means_a), np.asarray(means_b)
    if len(means_a) != len(means_b) or len(means_a) == 0:
        return np.inf
    best = np.inf
    for perm in itertools.permutations(range(len(means_b))):
        best = min(best, np.mean(np.sum((means_a - means_b[list(perm)]) ** 2, axis=1)))
    return best


@dataclass
class ClusteringMonitor:
    model: object
    robot_lim: object
    num_pts: int = 1000
    stable_thresh: float = 1e-3
    dir_path: str | None = None
    cluster_kwargs: dict = field(default_factory=dict)
    last_clusters: np.ndarray | None = None
    log: list = field(default_factory=list)

    def update(self, seeds_x, seeds_y, explr_step: int, checkpoint_fn=None, generator=None,
               draws=None):
        """One clustering pass; returns (result, stable). When stable,
        ``checkpoint_fn(explr_step)`` is called. ``generator``/``draws`` go
        to ``find_clusters``."""
        res = find_clusters(self.model, seeds_x, seeds_y, robot_lim=self.robot_lim,
                            num_pts=self.num_pts, generator=generator, draws=draws,
                            **self.cluster_kwargs)
        stable, error = False, np.inf
        if self.last_clusters is not None:
            error = cluster_stability_error(res.means, self.last_clusters)
            stable = error < self.stable_thresh
            if stable and checkpoint_fn is not None:
                checkpoint_fn(explr_step)
        self.log.append({"step": explr_step,
                         "error": float(error) if np.isfinite(error) else "NA",
                         "num_clusters": len(res.means), "clusters": res.means.tolist(),
                         "stable": stable})
        self.last_clusters = res.means
        return res, stable

    def save_log(self, name: str = "cluster_log.csv"):
        """Write the log as CSV in ``dir_path``; returns the path (None
        without ``dir_path``)."""
        if not self.dir_path:
            return None
        os.makedirs(self.dir_path, exist_ok=True)
        path = os.path.join(self.dir_path, name)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["step", "error", "num_clusters", "clusters",
                                              "stable"])
            w.writeheader()
            w.writerows(self.log)
        return path

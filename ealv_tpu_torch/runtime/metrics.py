"""Run metrics, logging and artifacts: a numpy-only copy of
``ealv_tpu/runtime/metrics.py``.

The JAX module is framework-free, but importing it runs
``ealv_tpu/runtime/__init__.py``, which imports JAX, so the port carries its
own copy. A per-run ``log.txt`` gets "explr_step learning_step ratio loss |
runtime" progress lines; the loss, beta, gamma and ergodic-cost series are
stored as ``metrics.npz`` with a ``metrics_summary.json``.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from collections import defaultdict

import numpy as np


class MetricsLog:
    def __init__(self, dir_path: str | None = None, echo: bool = True):
        self.dir_path = dir_path
        self.echo = echo
        self.series = defaultdict(list)
        self.start = time.time()
        if dir_path:
            os.makedirs(dir_path, exist_ok=True)
            self.write_to_log(datetime.datetime.now().isoformat())
            self.write_to_log("explr_step learning_step ratio loss \t| runtime")

    # ---- text log ----
    def write_to_log(self, msg: str) -> None:
        if self.echo:
            print(msg)
        if self.dir_path:
            with open(os.path.join(self.dir_path, "log.txt"), "a") as f:
                f.write(msg + "\n")

    @property
    def duration_str(self) -> str:
        return str(datetime.timedelta(seconds=int(time.time() - self.start)))

    def progress(self, explr_step: int, learning_ind: int, loss: float) -> None:
        ratio = learning_ind / max(explr_step, 1)
        self.write_to_log(
            f"{explr_step} {learning_ind} {ratio:.2f} {loss:.4f} \t| {self.duration_str}"
        )

    # ---- series ----
    def push(self, **kv) -> None:
        for k, v in kv.items():
            self.series[k].append(np.asarray(v))

    def push_tick_info(self, info: dict) -> None:
        """Record a run_chunk/tick info dict (arrays get stacked)."""
        for k, v in info.items():
            self.series[k].append(np.asarray(v))

    def save(self, name: str = "metrics") -> str | None:
        if not self.dir_path:
            return None
        out = {}
        for k, v in self.series.items():
            try:
                out[k] = np.concatenate([np.atleast_1d(x) for x in v], axis=0)
            except ValueError:
                out[k] = np.asarray(v, dtype=object)
        path = os.path.join(self.dir_path, f"{name}.npz")
        np.savez_compressed(path, **{k: v for k, v in out.items()
                                     if v.dtype != object})
        summary = {
            k: {"last": float(np.ravel(v)[-1]), "n": int(np.ravel(v).shape[0])}
            for k, v in out.items() if v.dtype != object and v.size
        }
        with open(os.path.join(self.dir_path, f"{name}_summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return path


def run_dir(base: str, sensor: str, method: str, seed: int, mod: str = "") -> str:
    """Run directory layout: {base}/{sensor}/{method}_{seed:04d}{mod}/"""
    return os.path.join(base, sensor, f"{method}_{seed:04d}{mod}")

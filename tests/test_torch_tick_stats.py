"""Whole runs of the explore-and-learn tick, the port against the JAX
``Experiment`` statistically: each package draws its own randoms, so the
runs are compared over seeds, not step by step (that is
``test_torch_tick.py``). Kept in its own file so that it runs on its own
test worker."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_tick import TOY
from test_torch_trainer import one_torch_thread  # noqa: F401


def test_twenty_ticks_statistically_like_jax():
    """20 default-config (bf16) ticks on seeds 0-2 in each package, each
    drawing its own randoms: all values finite, and the port's mean
    ergodic cost and final loss lie within the JAX seeds' range widened by
    the larger of its spread and 25% of its mean magnitude."""
    cfg_j, cfg_t = JConfig(**TOY), ExperimentConfig(**TOY)
    exp_j = JExperiment(cfg_j, train_calls_per_tick=1, train_every=1)
    exp_t = Experiment(cfg_t, train_calls_per_tick=1, train_every=1)
    chunk = jax.jit(lambda s: exp_j.run_chunk(s, 20))
    stats = {"jax": [], "torch": []}
    for seed in range(3):
        _, inf = chunk(exp_j.init(seed=seed))
        stats["jax"].append((float(jnp.mean(inf["ergodic_cost"])), float(inf["loss"][-1])))
        _, inf = exp_t.run_chunk(exp_t.init(seed=seed), 20)
        for v in inf.values():
            assert torch.isfinite(v.float()).all()
        stats["torch"].append((float(inf["ergodic_cost"].mean()), float(inf["loss"][-1])))
    j, t = np.array(stats["jax"]), np.array(stats["torch"])
    assert np.isfinite(j).all()
    for col, name in ((0, "mean ergodic cost"), (1, "final loss")):
        lo, hi = j[:, col].min(), j[:, col].max()
        margin = max(hi - lo, 0.25 * np.abs(j[:, col]).mean())
        got = t[:, col].mean()
        assert lo - margin <= got <= hi + margin, (name, j[:, col], t[:, col])

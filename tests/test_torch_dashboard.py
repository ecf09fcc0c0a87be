"""The live dashboard (``ealv_tpu_torch/viz/dashboard.py``) against the JAX
``LiveDashboard`` on the same state: one step-matched tick of the toy
experiment (the JAX keys' draws fed to the port, converted weights, f32,
TF32 off; that tick plans and does not train), then the payload of each
side over the 50x50 grid and a rendered frame.

Tolerances: sensor view, path and current state at 1e-4 (they follow the
first control, as in tests/test_torch_tick.py); reconstruction and latent
statistics at rtol 1e-4, atol 1e-5 (the CVAE's forward, as in
tests/test_torch_cvae.py); the plan at rtol 2e-3, atol 2e-4 and the p and q
grids at rtol 2e-3, atol 1e-6 (the planner's footprint forms differ, as in
tests/test_torch_planner.py).
"""

import jax
import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu.viz import LiveDashboard as JDashboard
from ealv_tpu_torch.control import klerg
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import params_from_jax
from ealv_tpu_torch.viz import LiveDashboard
from test_torch_tick import TOY, _jax_tick_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"image": (1e-4, 1e-5), "path": (1e-4, 1e-5), "cur": (1e-4, 1e-5),
       "img_pred": (1e-4, 1e-5), "z_mu": (1e-4, 1e-5), "z_var": (1e-4, 1e-5),
       "plan": (2e-3, 2e-4), "p": (2e-3, 1e-6), "q": (2e-3, 1e-6)}


def _one_tick(method):
    """A JAX and a port experiment one step-matched tick in."""
    toy = {**TOY, "explr_method": method}
    exp_j = JExperiment(JConfig(**toy, compute_dtype="float32"), train_calls_per_tick=1)
    exp_t = Experiment(ExperimentConfig(**toy, compute_dtype="float32"),
                       train_calls_per_tick=1, device="cpu")
    es_j, es_t = exp_j.init(seed=0), exp_t.init(seed=0)
    es_t.model.load_state_dict(params_from_jax(es_j.params, es_t.model))
    es_j2, _ = jax.jit(exp_j.tick)(es_j)
    es_t, _ = exp_t.tick(es_t, _jax_tick_draws(exp_j, es_j, es_j2))
    assert es_t.learning_ind == int(es_j2.learning_ind) == 0
    return exp_j, es_j2, exp_t, es_t


@pytest.fixture
def k1_calls(monkeypatch):
    """Counts the planner's K1 calls (the footprint and the spread; the
    launch counter moves only on the card)."""
    calls = []
    for name in ("traj_footprint", "traj_spread"):
        fn = getattr(klerg, name)
        monkeypatch.setattr(klerg, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    return calls


@pytest.mark.parametrize("method", ["entklerg", "randomWalk"])
def test_payload_matches_jax(tmp_path, k1_calls, method):
    """Every field of the port's payload against the JAX ``_payload_fn`` on
    the same state: the same keys and shapes (a baseline has no p and q),
    the values at the tolerances above, and two K1 calls a planner payload
    (none for a baseline)."""
    exp_j, es_j, exp_t, es_t = _one_tick(method)
    want = jax.device_get(JDashboard(exp_j, str(tmp_path / "jax"))._payload(es_j))
    k1_calls.clear()  # the tick's own 13
    got = LiveDashboard(exp_t, str(tmp_path / "port")).payload(es_t)
    assert sorted(got) == sorted(want)
    assert ("p" in got) == (method == "entklerg")
    assert k1_calls == (["traj_spread", "traj_footprint"] if method == "entklerg" else [])
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        if k == "path_mask":
            np.testing.assert_array_equal(got[k], w)
        else:
            np.testing.assert_allclose(got[k], w, rtol=TOL[k][0], atol=TOL[k][1], err_msg=k)
    if method == "entklerg":
        assert got["p"].shape == (50, 50) and np.ptp(got["p"]) > 0


def test_render_writes_the_jax_files(tmp_path):
    """A frame with curves: dashboard.png (of the JAX frame's size, replaced
    in place on the next frame) beside dashboard.html, and nothing else."""
    exp_j, es_j, exp_t, es_t = _one_tick("entklerg")
    rng = np.random.default_rng(0)
    series = {"ergodic_cost": [rng.uniform(0, 3, 4)], "loss": [np.r_[0.0, 1.0, 0.5, 0.4]]}
    dj = JDashboard(exp_j, str(tmp_path / "jax"))
    dt = LiveDashboard(exp_t, str(tmp_path / "port"))
    want = dj.render(es_j, series, step=1)
    got = dt.render(es_t, series, step=1)
    got = dt.render(es_t, series, step=2)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir()) == ["dashboard.html", "dashboard.png"]
    assert mpimg.imread(got).shape == mpimg.imread(want).shape
    assert (tmp_path / "port" / "dashboard.html").read_text().startswith("<!doctype html>")

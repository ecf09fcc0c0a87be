"""The port's figures (``ealv_tpu_torch/viz/plotting.py``) against the JAX
package's on the same arrays: each plotter writes the file the JAX one
writes, at the same image size in pixels (pixels themselves are not
compared: the two draw the same panels with the same calls). Also: the
figure module imports no matplotlib until the first draw, and a draw
without matplotlib raises ImportError naming it.
"""

import os
import subprocess
import sys

import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from ealv_tpu import viz as jviz
from ealv_tpu.fingerprint.belief import FingerprintBelief as JBelief
from ealv_tpu_torch import viz as tviz
from ealv_tpu_torch.fingerprint.belief import FingerprintBelief
from test_torch_trainer import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_files(tmp_path, got, want):
    """Both sides wrote files of the same names and image sizes."""
    got, want = [got] if isinstance(got, str) else got, [want] if isinstance(want, str) else want
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert os.path.dirname(g) == str(tmp_path / "port")
        assert mpimg.imread(g).shape == mpimg.imread(w).shape, os.path.basename(g)


def _draw(tmp_path, make):
    """``make(viz_module, dir)`` on both sides; returns (port, jax) results."""
    return make(tviz, str(tmp_path / "port")), make(jviz, str(tmp_path / "jax"))


@pytest.fixture
def arrays():
    rng = np.random.default_rng(0)
    s = rng.uniform(-1, 1, (200, 2)).astype(np.float32)
    return dict(
        image=rng.uniform(0, 1, (24, 24, 3)).astype(np.float32),
        img_pred=rng.uniform(-0.1, 1.1, (24, 24, 3)).astype(np.float32),
        z_mu=rng.normal(size=8).astype(np.float32),
        z_var=rng.uniform(0.1, 1, 8).astype(np.float32),
        path_xy=rng.uniform(-1, 1, (30, 2)).astype(np.float32), samples=s,
        p=np.exp(-(s ** 2).sum(1)), q=rng.uniform(0, 1, 200),
        costs=rng.uniform(0, 5, 40))


def test_exploration_plotter(tmp_path, arrays):
    """Every panel filled, then the camera view alone (the run entry's
    final_view.png); torch tensors on the port's side."""
    got, want = _draw(tmp_path, lambda v, d: [
        v.ExplorationPlotter(d, robot_lim=[[-1, 1], [-1, 1]]).render(
            **{k: torch.from_numpy(np.asarray(a)) if v is tviz else a
               for k, a in arrays.items()}, step=7),
        v.ExplorationPlotter(d).render(image=arrays["image"], step=3, name="final_view.png")])
    _same_files(tmp_path, got, want)
    assert os.path.basename(got[0]) == "explr_00007.png"


def test_training_plotter(tmp_path):
    rng = np.random.default_rng(1)
    series = {k: rng.normal(size=n) for k, n in (("loss", 30), ("rc", 30), ("beta", 10),
                                                 ("gamma", 10), ("ergodic_cost", 12),
                                                 ("other", 5))}
    got, want = _draw(tmp_path, lambda v, d: v.TrainingPlotter(d).render(series))
    _same_files(tmp_path, got, want)


@pytest.mark.parametrize("latent", [True, False])
def test_eval_and_multi_eval_plotters(tmp_path, arrays, latent):
    imgs = [arrays["image"], arrays["img_pred"], arrays["image"][::-1]]
    lat = dict(z_mu=arrays["z_mu"], z_var=arrays["z_var"]) if latent else {}
    got, want = _draw(tmp_path, lambda v, d: [
        v.EvalPlotter(d).render(*imgs, **lat),
        v.MultiEvalPlotter(d).render([imgs, [*imgs, "pose b"], imgs])])
    _same_files(tmp_path, got, want)


def test_belief_plotter(tmp_path):
    """Two xyw beliefs of 8 points a dimension with a fused measurement
    each (the port's on the CPU), marginalized over the yaw."""
    lims = np.array([[-1, 1], [-1, 1], [-0.5, 0.5]], np.float32)
    meas = np.array([[0.2, -0.3, 0.1], [0.5, 0.5, -0.2]], np.float32)
    tb, jb = [], []
    for k in range(2):
        t = FingerprintBelief.create("xyw", lims, num_samples=8, meas_capacity=4,
                                     device="cpu")
        j = JBelief.create("xyw", lims, num_samples=8, meas_capacity=4)
        tb.append(t.push(torch.from_numpy(meas[k]), torch.tensor(0.5)).update_prior())
        j = j.push(meas[k], 0.5)
        jb.append(j.update_prior())
    kw = dict(names=["a", "b"], truth_xy=[(0.2, -0.3), (0.5, 0.5)])
    port = tviz.BeliefPlotter(str(tmp_path / "port")).render(tb, **kw)
    jax_ = jviz.BeliefPlotter(str(tmp_path / "jax")).render(jb, **kw)
    _same_files(tmp_path, port, jax_)


def test_entropy_slices_and_clusters(tmp_path, arrays):
    """The slice figures (one per z-range variant) and the cluster figure
    with an outlier label, old centres and the uncertainty field."""
    s = arrays["samples"]
    slices = {n: (s, np.abs(s[:, 0]) + k) for k, n in enumerate(("posz", "negz", "allz"))}
    labels = np.where(s[:, 0] > 0, 1, 0)
    labels[:5] = -1
    means = np.array([[-0.5, 0.0, 0.1], [0.5, 0.0, 0.1]])
    got, want = _draw(tmp_path, lambda v, d: [
        *v.plot_entropy_slices(d, slices),
        v.plot_clusters(d, s, labels, means, samples=s, weights=arrays["p"],
                        last_means=means + 0.1)])
    _same_files(tmp_path, got, want)
    assert [os.path.basename(p) for p in got[:3]] == [
        "entropy_dist_posz.png", "entropy_dist_negz.png", "entropy_dist_allz.png"]


def test_viz_exports_the_jax_names():
    names = lambda m: {n for n in dir(m) if not n.startswith("_")}
    assert names(tviz) == names(jviz)


def test_matplotlib_loads_at_the_first_draw(tmp_path):
    """Importing the port (viz included) loads no matplotlib; with
    matplotlib unimportable a draw raises ImportError naming it."""
    code = ("import sys\n"
            "import ealv_tpu_torch.viz, ealv_tpu_torch.scripts.run_experiment\n"
            "assert 'matplotlib' not in sys.modules, 'imported at package import'\n"
            "sys.modules['matplotlib'] = None\n"
            "try:\n"
            f"    ealv_tpu_torch.viz.TrainingPlotter({str(tmp_path)!r})\n"
            "except ImportError as e:\n"
            "    assert 'matplotlib' in str(e), e\n"
            "    print('raised')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"

"""Offline evaluation (``runtime/evaluate.py``), the trajectory generators
(``utils/trajectories.py``) and the test-set collector
(``scripts/collect_test_set.py``) against the JAX package.

The CVAE runs from converted weights, f32 with TF32 off: reconstruction
metrics, latents and decoded images at rtol 1e-4 (as
``test_torch_cvae.py``); trajectories bit for bit; the collector's npz
against the JAX script's at the renderer's tolerance of
``test_torch_sim.py`` (1e-5).
"""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.runtime import evaluate as jev
from ealv_tpu.utils import trajectories as jtraj
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.runtime import evaluate as tev
from ealv_tpu_torch.scripts import collect_test_set as tcollect
from ealv_tpu_torch.utils import trajectories as ttraj
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, S_DIM, Z_DIM, HIDDEN = (24, 24, 3), 3, 8, (64, 32)


def _models(learn_force):
    jm = JCVAE(img_dim=IMG, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
               learn_force=learn_force)
    jp = jm.init({"params": jax.random.PRNGKey(2)}, jnp.zeros((1, S_DIM)),
                 jnp.zeros((1, *IMG)), force=jnp.zeros((1, 1)) if learn_force else None,
                 train=False)
    tm = CVAE(img_dim=IMG, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
              learn_force=learn_force)
    tm.load_state_dict(params_from_jax(jp, tm))
    return jm, jp, tm


def _set(n=9, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, S_DIM)).astype(np.float32),
            rng.uniform(0, 1, (n, *IMG)).astype(np.float32),
            rng.uniform(0, 30, (n, 1)).astype(np.float32))


@pytest.mark.parametrize("learn_force", [False, True])
def test_evaluate_test_set_matches_jax(learn_force):
    jm, jp, tm = _models(learn_force)
    poses, images, forces = _set()
    want = jev.evaluate_test_set(jm, jp, poses, images, forces)
    got = tev.evaluate_test_set(tm, poses, images, forces)
    assert set(got) == set(want)
    for k in ("recon_mse", "recon_nll", "z_mu", "z_logvar", "img_pred"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k in ("mean_mse", "mean_nll"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["active_units"] == want["active_units"]
    assert isinstance(got["mean_nll"], float) and isinstance(got["active_units"], int)


@pytest.mark.parametrize("learn_force", [False, True])
def test_imagined_views_match_jax(learn_force):
    jm, jp, tm = _models(learn_force)
    poses, images, forces = _set(seed=1)
    seed_force = forces[0] if learn_force else None
    want = jev.imagined_views(jm, jp, poses[0], images[0], poses[1:4], seed_force)
    got = tev.imagined_views(tm, poses[0], images[0], poses[1:4], seed_force)
    for g, w, what in zip(got, want, ("images", "y_logvar")):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=what)


def test_eval_report_waits_for_the_figures(tmp_path):
    """eval_report waited for the figure module; now it draws: on one npz
    (tray poses, as the collector writes them) the port's and the JAX
    report give the same metrics (rtol 1e-4, as above) and write the same
    files at the same image sizes."""
    import matplotlib.image as mpimg
    jm, jp, tm = _models(False)
    rng = np.random.default_rng(4)
    poses = np.zeros((5, 6), np.float32)
    poses[:, :3] = rng.uniform([0.3, -0.15, 0.3], [0.65, 0.15, 0.5], (5, 3))
    path = str(tmp_path / "ts.npz")
    np.savez(path, poses=poses, images=rng.uniform(0, 1, (5, *IMG)).astype(np.float32),
             forces=np.zeros((5, 1), np.float32))
    want = jev.eval_report(jm, jp, path, str(tmp_path / "jax"), n_panels=3)
    got = tev.eval_report(tm, path, str(tmp_path / "port"), n_panels=3)
    for k in ("recon_mse", "recon_nll", "z_mu", "z_logvar", "img_pred"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) == [
        "eval_0.png", "eval_1.png", "eval_2.png"]
    for f in files:
        assert (mpimg.imread(str(tmp_path / "port" / f)).shape
                == mpimg.imread(str(tmp_path / "jax" / f)).shape), f


@pytest.mark.parametrize("n", [9, 10, 25])
def test_trajectories_equal_jax(n):
    np.testing.assert_array_equal(ttraj.grid_traj(0.3, n, (0.475, 0.0)),
                                  jtraj.grid_traj(0.3, n, (0.475, 0.0)))
    np.testing.assert_array_equal(ttraj.circular_traj(0.1, n, (0.475, 0.0), start=0),
                                  jtraj.circular_traj(0.1, n, (0.475, 0.0), start=0))
    np.testing.assert_array_equal(
        ttraj.circular_traj(0.1, n, rng=np.random.default_rng(3)),
        jtraj.circular_traj(0.1, n, rng=np.random.default_rng(3)))


@pytest.mark.parametrize("pattern,n", [("grid", 9), ("circle", 6)])
def test_collector_npz_matches_the_jax_script(tmp_path, monkeypatch, pattern, n):
    """The port's collector (``--device cpu``) and the JAX script write the
    same keys, shapes and dtypes; poses equal, images and forces within the
    renderer's tolerance."""
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    flags = ["--pattern", pattern, "--n", str(n), "--img", "24", "--z", "0.3"]
    tcollect.main([*flags, "--out", ours, "--device", "cpu"])
    script = os.path.join(REPO, "scripts", "collect_test_set.py")
    monkeypatch.setattr(sys, "argv", [script, *flags, "--out", theirs])
    runpy.run_path(script, run_name="__main__")
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files) == ["forces", "images", "poses"]
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    np.testing.assert_array_equal(a["poses"], b["poses"])
    np.testing.assert_allclose(a["images"], b["images"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a["forces"], b["forces"], rtol=1e-5, atol=1e-5)
    assert a["images"].shape == (n, 24, 24, 3)

"""Object discovery (``fingerprint/clustering.py``) and entropy slices
(``fingerprint/entropy.py``) against the JAX package on the same inputs:
the JAX ``split(key, 3)`` uniform and categorical draws of
``find_clusters`` and the replay ring's ``sample_indices`` of
``entropy_slice`` are fed to the port. f32 on the CPU; 1e-4 for the
decoded scores, ``optimize_samples`` after 5 Adam steps and the entropy
marginals. Cluster labels are compared exactly: the inputs here keep every
point's mean-shift and mode decisions clear of their thresholds by far
more than the f32 differences (checked in the test).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.control import setup_barrier as j_setup_barrier
from ealv_tpu.data.replay import ReplayBuffer as JReplay
from ealv_tpu.fingerprint import clustering as jcl, entropy as jen
from ealv_tpu_torch.control import setup_barrier
from ealv_tpu_torch.data.replay import ReplayBuffer
from ealv_tpu_torch.fingerprint import clustering as tcl, entropy as ten
from test_torch_fingerprint import close, configs, model_pair, t
from test_torch_trainer import one_torch_thread  # noqa: F401


def seeds(cfg, n, rng):
    x = rng.uniform(-1, 1, (n, cfg.s_dim)).astype(np.float32)
    y = rng.uniform(0, 1, (n, *cfg.image_dim)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("dx", [False, True])
def test_score_samples_matches_jax(dx):
    """The mean decoded variance under 3 seeds, cubed, from one decode of
    S*N rows; with ``dx`` the samples are taken relative to each seed."""
    jc, _ = configs()
    jm, jp, tm = model_pair(jc, dx=dx)
    rng = np.random.default_rng(0)
    sx, sy = seeds(jc, 3, rng)
    samples = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    got = tcl.score_samples(tm, t(sx), t(sy), t(samples))
    want = jcl.score_samples(jm, jp, jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(samples))
    close(got, want, 1e-6, rtol=1e-4)


def barriers(states="xyw"):
    jc, _ = configs()
    d = len(states)
    lim, ctrl = jc.robot_lim[:d], jc.robot_ctrl_lim[:d]
    jb, _ = j_setup_barrier(states, jnp.asarray(lim), jnp.asarray(ctrl), list(range(d)))
    tb, _ = setup_barrier(states, t(lim), t(ctrl), list(range(d)))
    return jb.truncate(d), tb.truncate(d)


@pytest.mark.parametrize("with_barrier", [False, True])
def test_optimize_samples_matches_jax(with_barrier):
    """5 Adam steps on the sample positions (kernel repulsion, the seeds'
    renormalized pdfs, the barrier); the model's parameters get no
    gradient. ``renormalize`` sends its max term's gradient to the argmax
    sample alone, so where two samples' pdfs tie to f32 noise the two
    packages may pick different ones (inputs from seed 1 do, off by 1e-3
    after 4 steps); the inputs here keep the lead clear at every step."""
    jc, _ = configs()
    jm, jp, tm = model_pair(jc)
    rng = np.random.default_rng(2)
    sx, sy = seeds(jc, 2, rng)
    samples = rng.uniform(-1.2, 1.2, (60, 3)).astype(np.float32)
    jb, tb = barriers() if with_barrier else (None, None)
    got = tcl.optimize_samples(tm, t(sx), t(sy), t(samples), barrier=tb)
    want = jcl.optimize_samples(jm, jp, jnp.asarray(sx), jnp.asarray(sy),
                                jnp.asarray(samples), barrier=jb)
    close(got, want, 1e-4)
    assert float((got - t(samples)).abs().max()) > 1e-2  # they moved
    z = tcl._encode_seed_z(tm, t(sx), t(sy))
    for k in range(5):
        pts = tcl.optimize_samples(tm, t(sx), t(sy), t(samples), barrier=tb, iters=k)
        with torch.no_grad():
            top2 = torch.exp(tcl._decode_logvar(tm, z, t(sx), pts)).amax(2).topk(2, 1).values
        assert float((top2[:, 0] / top2[:, 1] - 1).min()) > 1e-5
    assert all(p.grad is None for p in tm.parameters())


def test_reweight_resample_prefers_heavy_rows():
    samples = torch.linspace(-1, 1, 100)[:, None]
    w = torch.where(torch.arange(100) > 50, 10.0, 0.01)
    out = tcl.reweight_resample(samples, w, 400, torch.Generator().manual_seed(0))
    assert (out[:, 0] > 0).float().mean() > 0.9
    idx = torch.tensor([3, 3, 99])
    assert torch.equal(tcl.reweight_resample(samples, w, 3, idx=idx), samples[idx])


def blobs(rng, n=60):
    a = rng.normal((-0.5, -0.5), 0.05, (n, 2))
    b = rng.normal((0.5, 0.5), 0.05, (n, 2))
    c = rng.normal((0.5, -0.5), 0.05, (n // 6, 2))  # too small a cluster: label -1
    return np.vstack([a, b, c]).astype(np.float32)


def test_mean_shift_and_modes_match_jax():
    X = blobs(np.random.default_rng(2))
    got = tcl.mean_shift(t(X), 0.3)
    want = jcl.mean_shift(jnp.asarray(X), 0.3)
    close(got, want, 1e-6)
    tm_, tl = tcl.extract_modes(got.numpy(), 0.3)
    jm_, jl = jcl.extract_modes(np.asarray(want), 0.3)
    close(tm_, jm_, 1e-6)
    np.testing.assert_array_equal(tl, jl)
    assert len(tm_) == 3 and (tl >= 0).sum() == 130


def test_extract_modes_drops_small_clusters():
    X = blobs(np.random.default_rng(3))
    means, labels = tcl.extract_modes(tcl.mean_shift(t(X), 0.3).numpy(), 0.3, min_count=11)
    assert len(means) == 2 and (labels == -1).sum() == 10


@pytest.mark.parametrize("thresh", [0.04, 0.5])
def test_merge_overlapping_matches_jax(thresh):
    means = np.array([[0.0, 0.0], [0.1, 0.0], [1.0, 1.0], [1.05, 0.9]])
    labels = np.array([0, 1, 2, 3, 0, 1, -1, 3])
    got, want = (m.merge_overlapping(means, labels, thresh) for m in (tcl, jcl))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def cluster_inputs(optimize, num_pts=240, blank=False):
    """The JAX pipeline's draws for ``find_clusters``: uniform samples from
    k1, the categorical resampling (and blank) indices from k2 (k3) over
    the JAX weights."""
    jc, _ = configs(states="xy")
    jm, jp, tm = model_pair(jc, seed=3)
    rng = np.random.default_rng(4)
    sx, sy = seeds(jc, 3, rng)
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    lim = jnp.asarray(jc.robot_lim)
    samples = jax.random.uniform(k1, (num_pts, 2), minval=lim[:, 0], maxval=lim[:, 1])
    jb, tb = barriers("xy")
    moved = samples
    if optimize:
        moved = jnp.clip(jcl.optimize_samples(jm, jp, jnp.asarray(sx), jnp.asarray(sy),
                                              samples, barrier=jb), lim[:, 0], lim[:, 1])
    w = jcl.score_samples(jm, jp, jnp.asarray(sx), jnp.asarray(sy), moved)
    idx = jax.random.categorical(k2, jnp.log(jnp.maximum(w, 1e-30)), shape=(num_pts // 2,))
    bidx = None
    if blank:
        inv = -w + jnp.min(w) + jnp.max(w)
        bidx = jax.random.categorical(k3, jnp.log(jnp.maximum(inv, 1e-30)),
                                      shape=(num_pts // 2,))
    draws = tcl.ClusterDraws(samples=t(samples), resample_idx=torch.as_tensor(np.array(idx)),
                             blank_idx=None if bidx is None else torch.as_tensor(np.array(bidx)))
    return jc, jm, jp, tm, sx, sy, key, jb, tb, draws


@pytest.mark.parametrize("optimize", [False, True], ids=["plain", "optimized"])
@pytest.mark.parametrize("method", ["shift", "kmeans"])
def test_find_clusters_matches_jax(method, optimize):
    """Shift and kmeans, with and without the sample optimization (and its
    barrier): the clustered points, the centres and the labels."""
    jc, jm, jp, tm, sx, sy, key, jb, tb, draws = cluster_inputs(optimize)
    kw = dict(robot_lim=jc.robot_lim, num_pts=240, cluster_method=method, bandwidth=0.3,
              use_optimize_samples=optimize, num_fingerprints=2)
    got = tcl.find_clusters(tm, t(sx), t(sy), barrier=tb, draws=draws, **kw)
    want = jcl.find_clusters(jm, jp, jnp.asarray(sx), jnp.asarray(sy), key, barrier=jb, **kw)
    close(got.points, want.points, 1e-4)
    if method == "shift":  # the decisions' margins are clear of the f32 noise
        shifted = tcl.mean_shift(torch.as_tensor(got.points), 0.3).numpy()
        d2 = ((shifted[:, None] - shifted[None]) ** 2).sum(-1)
        assert np.abs(d2 - 0.15 ** 2).min() > 1e-4
    assert got.means.shape == want.means.shape and len(got.means) >= 1
    close(got.means, want.means, 1e-4)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.blank_means is None


def test_find_clusters_blank_regions_match_jax():
    jc, jm, jp, tm, sx, sy, key, _, _, draws = cluster_inputs(False, blank=True)
    kw = dict(robot_lim=jc.robot_lim, num_pts=240, bandwidth=0.3, get_blank=True)
    got = tcl.find_clusters(tm, t(sx), t(sy), draws=draws, **kw)
    want = jcl.find_clusters(jm, jp, jnp.asarray(sx), jnp.asarray(sy), key, **kw)
    close(got.blank_means, want.blank_means, 1e-4)


def test_find_clusters_draws_from_a_generator():
    """Without fed draws the samples and the resampling come from the
    generator: the same seed gives the same result."""
    jc, _ = configs(states="xy")
    tm = model_pair(jc)[2]
    sx, sy = seeds(jc, 2, np.random.default_rng(6))
    runs = [tcl.find_clusters(tm, t(sx), t(sy), jc.robot_lim, num_pts=100,
                              cluster_method="kmeans",
                              generator=torch.Generator().manual_seed(7)) for _ in range(2)]
    np.testing.assert_array_equal(runs[0].points, runs[1].points)
    assert runs[0].points.shape == (50, 2) and np.abs(runs[0].points).max() <= 1.0


def test_gmm_without_sklearn_raises(monkeypatch):
    """No quiet fallback to another method when sklearn is missing."""
    jc, _ = configs(states="xy")
    tm = model_pair(jc)[2]
    sx, sy = seeds(jc, 2, np.random.default_rng(6))
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.mixture", None)
    with pytest.raises(ImportError):
        tcl.find_clusters(tm, t(sx), t(sy), jc.robot_lim, num_pts=40, cluster_method="gmm",
                          generator=torch.Generator().manual_seed(0))


def test_unknown_cluster_method_raises():
    jc, _ = configs(states="xy")
    tm = model_pair(jc)[2]
    sx, sy = seeds(jc, 2, np.random.default_rng(6))
    with pytest.raises(ValueError, match="unknown cluster method"):
        tcl.find_clusters(tm, t(sx), t(sy), jc.robot_lim, num_pts=40, cluster_method="dbscan",
                          generator=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------- entropy slices

def test_slice_lims_matches_jax():
    lims = np.array([[-1, 1], [-0.5, 0.8], [-1, 1]], np.float32)
    for pin in (None, (2, 0), (2, 1)):
        np.testing.assert_array_equal(ten._slice_lims(lims, 1.15, pin),
                                      jen._slice_lims(lims, 1.15, pin))


def rings(cfg, n, rng, force=False):
    """The same n samples pushed to a JAX and a port replay ring."""
    jb = JReplay.create(32, cfg.s_dim, cfg.image_dim)
    tb = ReplayBuffer.create(32, cfg.s_dim, cfg.image_dim, "cpu")
    for _ in range(n):
        x = rng.uniform(-1, 1, cfg.s_dim).astype(np.float32)
        y = rng.uniform(0, 1, cfg.image_dim).astype(np.float32)
        f = rng.uniform(0, 5, 1).astype(np.float32)
        jb = jb.push(jnp.asarray(x), jnp.asarray(y), jnp.asarray(f))
        tb.push(t(x), t(y), t(f))
    return jb, tb


@pytest.mark.parametrize("states,ensemble,dx,force", [
    ("xyw", False, False, False), ("xyw", True, False, False), ("xyzw", False, True, False),
    ("xyzw", True, False, True)])
def test_entropy_slices_match_jax(states, ensemble, dx, force):
    """Every variant (posz, negz, allz with z; all without) from the same
    key: the plot samples and the seed-averaged, renormalized, marginalized
    pdf, with the z-ensemble, the dx model and the force variant."""
    jc, _ = configs(states=states)
    jm, jp, tm = model_pair(jc, dx=dx, learn_force=force)
    jbuf, tbuf = rings(jc, 12, np.random.default_rng(8))
    key = jax.random.PRNGKey(9)
    k_samp, k_seed = jax.random.split(key)
    kw = dict(num_samples=40, num_seeds=4, grid_pts=4, use_z_ensemble=ensemble)
    unit = np.asarray(jax.random.uniform(k_samp, (40, 2)))
    idx = np.asarray(jbuf.sample_indices(k_seed, 4, weighted=False))
    want = jen.entropy_slices(jm, jp, jbuf, key, jc.robot_lim, states, **kw)
    got = ten.entropy_slices(tm, tbuf, jc.robot_lim, states, unit_plane=t(unit),
                             seed_idx=torch.as_tensor(np.array(idx)), **kw)
    assert list(got) == list(want) == (["posz", "negz", "allz"] if "z" in states else ["all"])
    for name in want:
        close(got[name][0], want[name][0], 1e-6, f"{name} plane")
        close(got[name][1], want[name][1], 1e-4, f"{name} marginal")
        assert got[name][1].shape == (44,) and got[name][1].max() > 0


def test_entropy_slice_draws_from_a_generator():
    jc, _ = configs()
    tm = model_pair(jc)[2]
    _, tbuf = rings(jc, 6, np.random.default_rng(10))
    outs = [ten.entropy_slice(tm, tbuf, jc.robot_lim, num_samples=30, num_seeds=3,
                              grid_pts=3, generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert outs[0][0].shape == (34, 2) and np.isfinite(outs[0][1]).all()

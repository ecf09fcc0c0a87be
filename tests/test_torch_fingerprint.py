"""The fingerprint stage's distances, belief grids, identification, files
and clustering monitor (``ealv_tpu_torch/fingerprint/``) against the JAX
package on the same inputs, made with numpy from a seed; CVAE weights cross
by ``params_from_jax``. f32 on the CPU. Tolerances: 1e-6 absolute for the
distances and the belief's fusion, 1e-5 for relative poses (angles
compared wrapped), 1e-4 for whatever goes through the CVAE. The fusion
also takes rtol 5e-5: it rescales the renormalized measurement variance
into [scale, 50 scale], which turns the 1-ulp differences of XLA's and
torch's f32 log and exp (5e-7 after ``renormalize``) into relative
differences of up to 2.5e-5 where the variance is near ``scale``.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.fingerprint import belief as jbel, identify as jid, io as jio, \
    monitor as jmon
from ealv_tpu.fingerprint.distances import latent_distance as j_distance
from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.fingerprint import belief as tbel, identify as tid, io as tio, \
    monitor as tmon
from ealv_tpu_torch.fingerprint.clustering import ClusterDraws
from ealv_tpu_torch.fingerprint.distances import latent_distance
from ealv_tpu_torch.models import CVAE
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

# the JAX fingerprint tests' toy configuration (tests/test_fp_matrix.py)
TINY = dict(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
            cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
            num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
            batch_size=8, num_learning_opt=2, compute_dtype="float32")
METHODS = ["L2", "logprob", "KL", "BC"]
FUSION = dict(atol=1e-6, rtol=5e-5)


def configs(**kw):
    return JConfig(**{**TINY, **kw}), ExperimentConfig(**{**TINY, **kw})


def model_pair(cfg, learn_force=False, dx=False, seed=0):
    """A JAX CVAE, its parameters, and the port's CVAE with the same
    weights, at ``cfg``'s widths."""
    kw = dict(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
              hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
              cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels,
              learn_force=learn_force, dx=dx)
    jm = JCVAE(**kw)
    force = jnp.zeros((1, 1)) if learn_force else None
    jp = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, cfg.s_dim)),
                 jnp.zeros((1, *cfg.image_dim)), force=force, train=False)
    tm = CVAE(**kw)
    tm.load_state_dict(params_from_jax(jp, tm))
    return jm, jp, tm


def fp_dicts(k, s_counts, z, d, img, rng):
    """K capture dicts with the given seed counts, drawn from ``rng``."""
    return [{"z_mu": rng.standard_normal((s, z)).astype(np.float32) + 2.0 * i,
             "z_var": rng.uniform(-2.0, 0.5, (s, z)).astype(np.float32),
             "x": rng.uniform(-1, 1, (s, d)).astype(np.float32),
             "center": rng.uniform(-0.5, 0.5, d).astype(np.float32),
             "center_img": rng.uniform(0, 1, img).astype(np.float32)}
            for i, s in zip(range(k), s_counts)]


def close(a, b, atol, what="", rtol=0.0):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ---------------------------------------------------------------- distances

@pytest.mark.parametrize("shape", [(5, 8), (3, 4, 8), (8,)], ids=str)
@pytest.mark.parametrize("method", METHODS)
def test_latent_distance_matches_jax(method, shape):
    """Each method on 1-, 2- and 3-D inputs: L2 reduces every axis but the
    first, the others the last."""
    rng = np.random.default_rng(1)
    mu1, mu2 = rng.standard_normal((2, *shape)).astype(np.float32)
    lv1, lv2 = (rng.standard_normal((2, *shape)) * 0.5).astype(np.float32)
    got = latent_distance(method, t(mu1), t(lv1), t(mu2), t(lv2))
    want = j_distance(method, *map(jnp.asarray, (mu1, lv1, mu2, lv2)))
    assert tuple(got.shape) == want.shape
    close(got, want, 1e-6, method, rtol=1e-6)


def test_latent_distance_unknown_method_raises():
    z = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        latent_distance("cosine", z, z, z, z)


# ---------------------------------------------------------------- beliefs

def belief_pair(states="xyw", lims=None, **kw):
    lims = [[-1, 1]] * len(states) if lims is None else lims
    return (jbel.FingerprintBelief.create(states, lims, **kw),
            tbel.FingerprintBelief.create(states, lims, device="cpu", **kw))


def same_belief(tb, jb, atol=1e-6, what="", rtol=1e-6):
    for name in ("grid", "lims", "prior", "prior_var", "meas_loc", "meas_val"):
        close(getattr(tb, name), getattr(jb, name), atol, f"{what} {name}", rtol=rtol)
    assert int(tb.meas_n) == int(jb.meas_n) and int(tb.count) == int(jb.count)
    assert tb.num_samples == jb.num_samples
    assert tb.scale == pytest.approx(jb.scale, rel=1e-12)


@pytest.mark.parametrize("states,ns", [("xyw", 12), ("xy", 20), ("xyzw", 6)])
def test_belief_create_matches_jax(states, ns):
    """The widened limits (yaw 1.33x, all 1.15x), the 'xy'-indexed mesh and
    the kernel scale."""
    lims = [[-1.0, 1.0], [-0.8, 0.6], [-0.5, 0.9], [-1.0, 1.0]][: len(states)]
    jb, tb = belief_pair(states, lims, num_samples=ns, meas_capacity=8)
    same_belief(tb, jb, 0.0, states)


def test_belief_capacity_guard():
    with pytest.raises(ValueError, match="marginalize_angles"):
        tbel.FingerprintBelief.create("xyzw", [[-1, 1]] * 4, num_samples=50, device="cpu")
    b = tbel.FingerprintBelief.create("xyw", [[-1, 1]] * 3, num_samples=50, device="cpu")
    assert b.grid.shape == (125_000, 3)


@pytest.mark.parametrize("n_push,cap,invert", [(0, 8, False), (3, 8, False), (11, 4, False),
                                               (5, 16, True)])
def test_belief_fusion_matches_jax(n_push, cap, invert):
    """Rounds of pushes and fusions, the ring wrapping when n_push > cap:
    every tensor of the belief."""
    rng = np.random.default_rng(n_push)
    jb, tb = belief_pair("xyw", num_samples=10, meas_capacity=cap, thresh=0.8, clip=2.2,
                         invert=invert)
    for _ in range(3):
        locs = rng.uniform(-1, 1, (n_push, 3)).astype(np.float32)
        vals = rng.uniform(0.0, 2.5, n_push).astype(np.float32)
        for loc, val in zip(locs, vals):
            jb = jb.push(jnp.asarray(loc), jnp.asarray(val))
            tb = tb.push(t(loc), t(val))
        same_belief(tb, jb, what="pushed", **FUSION)
        jb, tb = jb.update_prior(), tb.update_prior()
        same_belief(tb, jb, what="fused", **FUSION)
    close(tb.pdf_grid(), jb.pdf_grid(), **FUSION)
    close(tb.pdf_grid(override_invert=True), jb.pdf_grid(override_invert=True), **FUSION)


def test_belief_is_a_value():
    """push, push_batch and update_prior return new beliefs; the old one is
    untouched."""
    b0 = tbel.FingerprintBelief.create("xy", [[-1, 1]] * 2, num_samples=8, device="cpu")
    before = {n: getattr(b0, n).clone() for n in ("prior", "prior_var", "meas_loc",
                                                   "meas_val", "meas_n", "count")}
    b1 = b0.push_batch(torch.tensor([[0.2, 0.3], [0.1, -0.4]]), torch.tensor([0.3, 1.5]))
    b2 = b1.update_prior()
    for n, v in before.items():
        assert torch.equal(getattr(b0, n), v), n
    assert int(b1.meas_n) == 2 and int(b2.meas_n) == 0 and int(b2.count) == 2
    assert not torch.equal(b2.prior, b0.prior)


@pytest.mark.parametrize("states,invert", [("xy", False), ("xyw", False), ("xyw", True)])
def test_belief_pdf_interpolation_matches_jax(states, invert):
    """Multilinear interpolation at points inside and outside the grid
    (clipped at ns - 1.001), after a fusion that shapes the prior."""
    rng = np.random.default_rng(7)
    d = len(states)
    jb, tb = belief_pair(states, num_samples=9, meas_capacity=8, invert=invert)
    for loc in rng.uniform(-1, 1, (4, d)).astype(np.float32):
        jb, tb = jb.push(jnp.asarray(loc), jnp.asarray(0.2)), tb.push(t(loc), t(0.2))
    jb, tb = jb.update_prior(), tb.update_prior()
    pts = rng.uniform(-1.6, 1.6, (300, d)).astype(np.float32)
    close(tb.pdf(t(pts)), jb.pdf(jnp.asarray(pts)), **FUSION)
    close(tb.pdf(t(pts), override_invert=True), jb.pdf(jnp.asarray(pts), True), **FUSION)


@pytest.mark.parametrize("method", ["mean", "max", "range", "WeightedAvg1", "WeightedAvg2"])
def test_marginalize_angles_matches_jax(method):
    p = np.random.default_rng(2).uniform(0, 1, 5 * 6 * 7).astype(np.float32)
    got = tbel.marginalize_angles(t(p), (5, 6, 7), (0, 1), method)
    close(got, jbel.marginalize_angles(jnp.asarray(p), (5, 6, 7), (0, 1), method), 1e-6,
          rtol=1e-6)


# ---------------------------------------------------------------- identification

def test_fingerprint_set_pads_like_jax():
    dicts = fp_dicts(3, (4, 6, 2), 8, 3, (24, 24, 3), np.random.default_rng(0))
    js, ts = jid.FingerprintSet.from_lists(dicts), tid.FingerprintSet.from_lists(dicts,
                                                                                 device="cpu")
    for name in js._fields:
        close(getattr(ts, name), getattr(js, name), 0.0, name)


# not BC with one fingerprint: its fallback's mean keeps the pairs with d
# > 0, and BC's self-pairs come out as rounding noise of either sign (log
# of exp(logvar) against logvar), so which of them count differs between
# XLA and torch, as it would between two runs of the reference elsewhere
@pytest.mark.parametrize("method,k", [("L2", 1), ("KL", 1), ("L2", 3), ("KL", 3), ("BC", 3)])
def test_calibrate_thresholds_matches_jax(method, k):
    """(thresh, clip) as floats: the cross-fingerprint min and twice the
    max, or with one fingerprint the within-fingerprint mean and max."""
    dicts = fp_dicts(k, (5, 3, 4)[:k], 6, 2, (8, 8, 3), np.random.default_rng(k))
    got = tid.calibrate_thresholds(tid.FingerprintSet.from_lists(dicts, device="cpu"), method)
    want = jid.calibrate_thresholds(jid.FingerprintSet.from_lists(dicts), method)
    assert all(isinstance(v, float) for v in got)
    close(got, want, 1e-6, rtol=1e-6)


def identify_inputs(learn_force=False):
    jc, tc = configs()
    jm, jp, tm = model_pair(jc, learn_force=learn_force)
    rng = np.random.default_rng(11)
    dicts = fp_dicts(3, (5, 7, 4), jc.z_dim, 3, jc.image_dim, rng)
    test_y = rng.uniform(0, 1, jc.image_dim).astype(np.float32)
    test_x = rng.uniform(-1, 1, 3).astype(np.float32)
    return (jc, jm, jp, jid.FingerprintSet.from_lists(dicts), tm,
            tid.FingerprintSet.from_lists(dicts, device="cpu"), test_x, test_y)


@pytest.mark.parametrize("method,error_mode,learn_force",
                         [(m, False, False) for m in METHODS]
                         + [("L2", True, False), ("KL", False, True)])
def test_identify_step_matches_jax(method, error_mode, learn_force):
    """K = 3 fingerprints of 5, 7 and 4 seeds (padded to 7): best distance
    and best seed pose of each, from one batched forward."""
    _, jm, jp, jfs, tm, tfs, test_x, test_y = identify_inputs(learn_force)
    jd, jx = jid.identify_step(jm, jp, jfs, jnp.asarray(test_x), jnp.asarray(test_y),
                               method, error_mode)
    td, tx = tid.identify_step(tm, tfs, t(test_x), t(test_y), method, error_mode)
    close(td, jd, 1e-4, "best dist", rtol=1e-4)
    close(tx, jx, 0.0, "best seed pose")


def wrap_close(got, want, atol, w_i):
    """Compare states; the yaw column modulo 2 pi of the tray angle."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(np.delete(got, w_i, 1), np.delete(want, w_i, 1), atol=atol)
    dw = got[:, w_i] - want[:, w_i]
    np.testing.assert_allclose(np.angle(np.exp(1j * dw * 2.0)), 0.0, atol=atol)


@pytest.mark.parametrize("states,reflect", [("xy", True), ("xyw", True), ("xyw", False),
                                            ("xyzw", True)])
def test_relative_pose_beliefs_matches_jax(states, reflect):
    """SO(2) composition in tray angles, the wrap, the yaw reflection and
    the reassembly in state order, for K = 4 matches at random yaws."""
    rng = np.random.default_rng(5)
    d = len(states)
    robot_lim = np.array([[-1.0, 1.0]] * d, np.float32)
    tray_lim = np.array([[0.3, 0.6], [-0.2, 0.2], [0.1, 0.5], [-2.0, 2.0]][:d], np.float32)
    tray_lim[-1] = [-2.0, 2.0]
    test = rng.uniform(-1, 1, d).astype(np.float32)
    fp = rng.uniform(-1, 1, (4, d)).astype(np.float32)
    ctr = rng.uniform(-1, 1, (4, d)).astype(np.float32)
    got = tid.relative_pose_beliefs(states, t(test), t(fp), t(ctr), robot_lim, tray_lim, reflect)
    want = jid.relative_pose_beliefs(states, jnp.asarray(test), jnp.asarray(fp),
                                     jnp.asarray(ctr), robot_lim, tray_lim, reflect)
    assert got.shape == want.shape
    if "w" not in states:
        close(got, want, 1e-5)
    else:  # robot yaw is tray yaw / 2 here: wrap the difference at pi
        wrap_close(got, want, 1e-5, states.rfind("w"))


@pytest.mark.parametrize("method,error_mode", [("L2", False), ("BC", False), ("L2", True)])
def test_update_beliefs_matches_jax(method, error_mode):
    """One identification tick over K = 3 beliefs: distances and the fused
    beliefs."""
    jc, jm, jp, jfs, tm, tfs, test_x, test_y = identify_inputs()
    lims = jc.robot_lim
    jbs = [jbel.FingerprintBelief.create("xyw", lims, num_samples=10, meas_capacity=8)
           for _ in range(3)]
    tbs = [tbel.FingerprintBelief.create("xyw", lims, num_samples=10, meas_capacity=8,
                                         device="cpu") for _ in range(3)]
    kw = dict(states="xyw", robot_lim=jc.robot_lim, tray_lim=jc.tray_lim, dist_method=method,
              error_mode=error_mode)
    jnew, jd = jid.update_beliefs(jm, jp, jfs, jbs, jnp.asarray(test_x), jnp.asarray(test_y),
                                  **kw)
    tnew, td = tid.update_beliefs(tm, tfs, tbs, t(test_x), t(test_y), **kw)
    close(td, jd, 1e-4, rtol=1e-4)
    for tb, jb in zip(tnew, jnew):
        same_belief(tb, jb, 1e-4, "updated")
    assert all(int(b.count) == (1 if error_mode else 2) for b in tnew)
    assert all(int(b.count) == 0 for b in tbs)  # the inputs are untouched


# ---------------------------------------------------------------- files

def test_fingerprint_files_load_alike(tmp_path):
    """Captures saved by the port load through both loaders, and the JAX
    package's files through the port's."""
    dicts = fp_dicts(2, (5, 3), 4, 2, (8, 8, 3), np.random.default_rng(3))
    tio.save_fingerprint(str(tmp_path / "a" / "fp0"), dicts[0])
    jio.save_fingerprint(str(tmp_path / "a" / "fp1.npz"), dicts[1])
    got, want = tio.load_fingerprints(str(tmp_path / "a")), jio.load_fingerprints(
        str(tmp_path / "a"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    tid.FingerprintSet.from_lists(got, device="cpu")


def test_reference_pickle_bridges_and_skips(tmp_path):
    """A reference pickle: variance to logvar, channel-first image to HWC,
    force kept; other pickles in a directory skipped with a warning, a
    listed one raises; as in the JAX loader."""
    rng = np.random.default_rng(4)
    good = {"z_mu": rng.standard_normal((5, 4)).astype(np.float32),
            "z_var": np.exp(rng.uniform(-3, 1, (5, 4))).astype(np.float32),
            "x": rng.uniform(-1, 1, (5, 2)).astype(np.float32),
            "center": np.array([0.1, -0.2], np.float32),
            "center_img": rng.uniform(0, 1, (3, 8, 8)).astype(np.float32),
            "force": rng.standard_normal((5, 1)).astype(np.float32)}
    with open(tmp_path / "duck.pickle", "wb") as f:
        pickle.dump(good, f)
    with open(tmp_path / "ergodic_cost.pickle", "wb") as f:
        pickle.dump(np.zeros(7, np.float32), f)
    with pytest.warns(UserWarning, match="skipping"):
        got = tio.load_fingerprints(str(tmp_path))
    with pytest.warns(UserWarning, match="skipping"):
        want = jio.load_fingerprints(str(tmp_path))
    assert len(got) == 1 and got[0]["center_img"].shape == (8, 8, 3)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    with pytest.raises(KeyError):
        tio.load_fingerprints([str(tmp_path / "ergodic_cost.pickle")])


def test_pickle_loader_refuses_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with open(tmp_path / "evil.pickle", "wb") as f:
        pickle.dump({"z_mu": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tio.load_fingerprints([str(tmp_path / "evil.pickle")])


def test_belief_files_cross_both_ways(tmp_path):
    """Beliefs saved by either package load into the other with the same
    grid, limits, prior, variance and count; the loaded beliefs fuse on."""
    jb, tb = belief_pair("xyw", num_samples=8, meas_capacity=8)
    loc = np.array([0.3, -0.2, 0.4], np.float32)
    jb = jb.push(jnp.asarray(loc), jnp.asarray(0.4)).update_prior()
    tb = tb.push(t(loc), t(0.4)).update_prior()
    tpath = tio.save_beliefs(str(tmp_path / "port"), [tb, tb], names=["a", "b"])
    jpath = jio.save_beliefs(str(tmp_path / "jax"), [jb, jb], names=["a", "b"])
    from_jax, names = tio.load_beliefs(jpath, "xyw", device="cpu", meas_capacity=8)
    from_port, jnames = jio.load_beliefs(tpath, "xyw", meas_capacity=8)
    assert names == jnames == ["a", "b"]
    for got, want in ((from_jax[1], jb), (tb, from_port[0])):
        for name in ("grid", "lims", "prior", "prior_var"):
            close(getattr(got, name), getattr(want, name), 0.0, name)
        assert int(got.count) == int(want.count) == 1 and int(got.meas_n) == 0
    close(tio._unexpand_lims("xyw", tb.lims), jio._unexpand_lims("xyw", jb.lims), 1e-12)
    more = from_jax[0].push(t(loc), t(1.8)).update_prior()
    assert int(more.count) == 2


# ---------------------------------------------------------------- monitor

@pytest.mark.parametrize("b", [[[0.1, 0.2], [0.5, -0.3], [-0.4, 0.4]], [[0.1, 0.2]], []])
def test_cluster_stability_error_matches_jax(b):
    a = [[0.52, -0.31], [-0.38, 0.41], [0.12, 0.19]]
    want = jmon.cluster_stability_error(a, b)
    got = tmon.cluster_stability_error(a, b)
    assert got == pytest.approx(want, rel=1e-12) or (np.isinf(got) and np.isinf(want))


def test_clustering_monitor_log_and_checkpoint(tmp_path):
    """Two passes on the same fed draws: the second is stable (error 0), the
    checkpoint runs at its step, and the CSV log has both rows."""
    _, tc = configs(states="xy")
    tm = model_pair(configs(states="xy")[0])[2]
    rng = np.random.default_rng(9)
    seeds_x = t(rng.uniform(-1, 1, (3, 2)))
    seeds_y = t(rng.uniform(0, 1, (3, *tc.image_dim)))
    mon = tmon.ClusteringMonitor(tm, tc.robot_lim, num_pts=200, dir_path=str(tmp_path),
                                 cluster_kwargs=dict(cluster_method="kmeans",
                                                     num_fingerprints=2))
    draws = ClusterDraws(samples=t(rng.uniform(-1, 1, (200, 2))),
                         resample_idx=torch.as_tensor(rng.integers(0, 200, 100)))
    saved = []
    _, stable0 = mon.update(seeds_x, seeds_y, 10, checkpoint_fn=saved.append, draws=draws)
    _, stable1 = mon.update(seeds_x, seeds_y, 20, checkpoint_fn=saved.append, draws=draws)
    assert (stable0, stable1, saved) == (False, True, [20])
    path = mon.save_log()
    lines = open(path).read().splitlines()
    assert lines[0] == "step,error,num_clusters,clusters,stable" and len(lines) == 3
    assert lines[1].startswith("10,NA,2,") and lines[2].startswith("20,0.0,2,")

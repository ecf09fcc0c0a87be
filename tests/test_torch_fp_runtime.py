"""Fingerprint capture (``fingerprint/capture.py``) and the identification
runtimes (``fingerprint/test_runtime.py``) against the JAX package, tick by
tick, with the JAX planner's draws (``jax_plan_draws``) fed to the port.
The JAX runtime is one fused scan; these tests hold the port against the
same body driven step by step (``EvalExperiment.tick`` and
``update_beliefs`` per combination), and one test holds the fused JAX run
equal to that composition. f32 on the CPU; 1e-4 for the captured latents
and poses and the runtimes' distances and states; the capture's
``center_img`` against the JAX one at 1e-5 (the same render of poses that
agree to 1e-6).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.fingerprint import belief as jbel, capture as jcap, identify as jid, \
    test_runtime as jrt
from ealv_tpu.runtime.tester import EvalExperiment as JEval
from ealv_tpu.utils.states import ws_conversion as j_ws
from ealv_tpu_torch.control import klerg as tklerg
from ealv_tpu_torch.fingerprint import belief as tbel, capture as tcap, identify as tid, \
    test_runtime as trt
from test_torch_fingerprint import close, configs, fp_dicts, model_pair, t
from test_torch_tester import jax_plan_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

COMBOS = (("L2", False), ("KL", False), ("BC", False), ("L2", True))


@pytest.mark.parametrize("mode,states", [("sphere", "xyw"), ("cylinder", "xyzw"),
                                         ("cone", "xyzw")])
def test_capture_target_matches_jax(mode, states):
    center = np.array([0.3, -0.2, 0.1, 0.4][: len(states)], np.float32)
    got = tcap.make_capture_target(states, center, mode, device="cpu")
    want = jcap.make_capture_target(states, center, mode)
    close(got.means, want.means, 0.0, "means")
    close(got.stds, want.stds, 0.0, "stds")
    assert int(got.size) == int(want.size) == (500 if mode == "cone" else 1)
    samples = t(np.random.default_rng(0).uniform(-1, 1, (50, len(states))))
    close(got.pdf(samples), want.pdf(jnp.asarray(samples)), 1e-6, rtol=1e-5)


def jax_capture_draws(cfg, center, explr_states, n, seed, scene=None):
    """The JAX capture's planner draws, tick by tick: its EvalExperiment
    from the same start, each tick's draws taken before the tick."""
    explr_states = explr_states or cfg.states
    target = jcap.make_capture_target(explr_states, center, "sphere")
    ev_exp = JEval(cfg, lambda ctx, s: ctx.pdf(s), explr_states=explr_states, scene=scene,
                   kernel_std_scale=0.1)
    center_tray = np.asarray(j_ws(jnp.asarray(center), ev_exp.robot_lim, ev_exp.tray_lim))
    pose6 = np.array([(lo + hi) / 2 for lo, hi in ev_exp.env.tray_lim], np.float32)
    for i, s in enumerate(explr_states):
        if "xyzrpw".find(s) >= 0:
            pose6[(("xyzrpw".find(s)))] = center_tray[i]
    ev = ev_exp.init(start_tray_pose=pose6, seed=seed, shrink_center=jnp.asarray(center))
    ev = ev_exp.use_pose(ev, jnp.asarray(pose6))
    tick = jax.jit(ev_exp.tick)
    draws = []
    for _ in range(n):
        draws.append(jax_plan_draws(ev_exp.planner, ev.pstate, ev_exp._measured(ev.env),
                                    cfg.num_target_samples, cfg.num_traj_samples))
        ev, _ = tick(ev, target)
    return draws


@pytest.mark.parametrize("explr_states", [None, "xy"])
def test_capture_fingerprint_matches_jax(explr_states):
    """A 3-tick capture around a centre, over all states and over the
    subset "xy" (with a model over x and y): the latents, poses, centre and
    ``center_img``, the JAX one from a separate tick that the port's first
    capture tick equals."""
    jc, tc = configs()
    jm, jp, tm = model_pair(configs(states=explr_states or "xyw")[0])
    center = np.array([0.2, -0.3, 0.0], np.float32)[: len(explr_states or "xyw")]
    draws = jax_capture_draws(jc, center, explr_states, 3, seed=1)
    want = jcap.capture_fingerprint(jm, jp, jc, center, num_steps=3, seed=1,
                                    explr_states=explr_states)
    got = tcap.capture_fingerprint(tm, tc, center, num_steps=3, seed=1,
                                   explr_states=explr_states, draws=draws, device="cpu")
    assert set(got) == set(want)
    for key in ("z_mu", "z_var", "x"):
        assert got[key].shape == want[key].shape, key
        close(got[key], want[key], 1e-4, key)
    close(got["center"], want["center"], 0.0)
    close(got["center_img"], want["center_img"], 1e-5, "center_img")
    assert got["center_img"].shape == tuple(tc.image_dim)


def test_capture_keeps_distinct_poses_only():
    """The greedy filter keeps a pose only ``min_pose_dist`` from the last
    kept one: all four at 0, the first alone at 10."""
    _, tc = configs()
    tm = model_pair(configs()[0])[2]
    center = np.array([0.1, 0.1, 0.0], np.float32)
    fps = [tcap.capture_fingerprint(tm, tc, center, num_steps=4, min_pose_dist=d, device="cpu")
           for d in (0.0, 10.0)]
    assert fps[0]["x"].shape == (4, 3) and fps[0]["z_mu"].shape == (4, tc.z_dim)
    assert fps[1]["x"].shape == (1, 3) and fps[1]["z_var"].shape == (1, tc.z_dim)
    np.testing.assert_array_equal(fps[1]["x"][0], fps[0]["x"][0])


def test_build_fingerprints_clusters_then_captures(tmp_path):
    """The pipeline: a capture at every centre the clustering finds (seed k
    for centre k), each saved as fp{k}_{mode}.npz and equal to a direct
    capture there."""
    from ealv_tpu_torch.fingerprint import io as tio
    from ealv_tpu_torch.fingerprint.clustering import ClusterDraws
    _, tc = configs()
    tm = model_pair(configs()[0])[2]
    rng = np.random.default_rng(13)
    sx, sy = t(rng.uniform(-1, 1, (3, 3))), t(rng.uniform(0, 1, (3, *tc.image_dim)))
    draws = ClusterDraws(samples=t(rng.uniform(-1, 1, (80, 3))),
                         resample_idx=torch.as_tensor(rng.integers(0, 80, 40)))
    fps, res = tcap.build_fingerprints(tm, tc, sx, sy, num_steps=2, num_pts=80,
                                       cluster_kwargs=dict(cluster_method="kmeans",
                                                           num_fingerprints=2),
                                       out_dir=str(tmp_path), cluster_draws=draws, device="cpu")
    assert len(fps) == len(res.means) == 2
    assert sorted(os.listdir(tmp_path)) == ["fp0_sphere.npz", "fp1_sphere.npz"]
    center = np.zeros(3, np.float32)
    center[:2] = res.means[1][:2]
    want = tcap.capture_fingerprint(tm, tc, center, num_steps=2, seed=1, device="cpu")
    got = tio.load_fingerprints(str(tmp_path))[1]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


# ---------------------------------------------------------------- identification

def small_beliefs(mod, cfg, fps, combos, **kw):
    """Beliefs per combination at a 12-point grid and an 8-slot ring (the
    runtimes' defaults are 50 points and 64 slots), thresholds calibrated
    from ``fps`` as the runtimes do."""
    out = {}
    for m, e in combos:
        th, cl = mod.calibrate_thresholds(fps, m)
        b = (jbel if mod is jid else tbel).FingerprintBelief
        out[f"{m}_error" if e else m] = [b.create(cfg.states, cfg.robot_lim, num_samples=12,
                                                  meas_capacity=8, thresh=th, clip=cl, **kw)
                                         for _ in range(fps.center.shape[0])]
    return out


@pytest.fixture(scope="module")
def id_setup():
    jc, tc = configs()
    jm, jp, tm = model_pair(jc)
    dicts = fp_dicts(2, (5, 4), jc.z_dim, 3, jc.image_dim, np.random.default_rng(12))
    return jc, tc, jm, jp, tm, jid.FingerprintSet.from_lists(dicts), \
        tid.FingerprintSet.from_lists(dicts, device="cpu")


def jax_step_by_step(rt, n_steps, seed, update_every):
    """The body of the JAX runtime's fused scan, driven tick by tick with
    jitted pieces. Returns (robot_state (n, d), dists (n, C, K), seek_k
    (n,), beliefs per combination, the planner draws of each tick)."""
    ev_exp, cfg = rt._ev, rt.cfg
    combos = rt.combos if hasattr(rt, "combos") else ((rt.dist_method, rt.error_mode),)
    seek_combo = getattr(rt, "seek_combo", 0)
    seek_mode = getattr(rt, "seek_mode", "fixed")
    keys = [f"{m}_error" if e else m for m, e in combos]
    beliefs = ([list(rt.beliefs[k]) for k in keys] if isinstance(rt.beliefs, dict)
               else [list(rt.beliefs)])
    tick = jax.jit(ev_exp.tick)
    updates = [jax.jit(lambda p, bs, s, y, m=m, e=e: jid.update_beliefs(
        rt.model, p, rt.fps, list(bs), s, y, states=cfg.states, robot_lim=cfg.robot_lim,
        tray_lim=cfg.tray_lim, dist_method=m, error_mode=e)) for m, e in combos]
    ev = ev_exp.init(seed=seed)
    rs, da, sk, draws = [], [], [], []
    for _ in range(n_steps):
        step = int(ev.step)
        if seek_mode == "uncertain":
            k = jnp.argmax(jrt._belief_entropies(beliefs[seek_combo]))
            seek_b = jax.tree.map(lambda *xs: jnp.stack(xs)[k], *beliefs[seek_combo])
        else:
            k = rt.seek_fingerprint
            seek_b = beliefs[seek_combo][k]
        if step < rt.update_tdist_step:
            seek_b = seek_b.replace(prior=jnp.full_like(seek_b.prior, 0.5),
                                    prior_var=jnp.full_like(seek_b.prior_var, 2.0))
        draws.append(jax_plan_draws(ev_exp.planner, ev.pstate, ev_exp._measured(ev.env),
                                    cfg.num_target_samples, cfg.num_traj_samples))
        ev, obs = tick(ev, seek_b)
        row = []
        for ci, upd in enumerate(updates):
            if step % update_every == 0:
                beliefs[ci], d = upd(rt.params, tuple(beliefs[ci]), obs["robot_state"],
                                     obs["image"])
                beliefs[ci] = list(beliefs[ci])
            else:
                d = jnp.full((rt.fps.center.shape[0],), jnp.nan)
            row.append(np.asarray(d))
        rs.append(np.asarray(obs["robot_state"]))
        da.append(np.stack(row))
        sk.append(int(k))
    return np.stack(rs), np.stack(da), np.array(sk), beliefs, draws


def matrix_pair(id_setup, seek_mode, combos=COMBOS, update_tdist_step=1):
    jc, tc, jm, jp, tm, jfs, tfs = id_setup
    kw = dict(combos=combos, seek_mode=seek_mode, update_tdist_step=update_tdist_step)
    rt_j = jrt.FingerprintMatrixRuntime(jc, jm, jp, jfs, beliefs=small_beliefs(jid, jc, jfs,
                                                                               combos), **kw)
    rt_t = trt.FingerprintMatrixRuntime(tc, tm, tfs, device="cpu",
                                        beliefs=small_beliefs(tid, tc, tfs, combos,
                                                              device="cpu"), **kw)
    return rt_j, rt_t


def same_history(rt_t, rs, da, sk, beliefs, update_every):
    keys = [rt_t.combo_key(m, e) for m, e in rt_t.combos]
    n = len(rs)
    assert [h["step"] for h in rt_t.history] == list(range(0, n, update_every))
    for h in rt_t.history:
        i = h["step"]
        close(h["robot_state"], rs[i], 1e-4, f"step {i} robot state")
        assert h["seek_k"] == sk[i], f"step {i} seek_k"
        for ci, key in enumerate(keys):
            close(h[key], da[i, ci], 1e-4, f"step {i} {key} dists", rtol=1e-4)
    np.testing.assert_array_equal(rt_t.seek_history, sk)
    for ci, key in enumerate(keys):
        for tb, jb in zip(rt_t.beliefs[key], beliefs[ci]):
            close(tb.prior, jb.prior, 1e-4, f"{key} prior")
            close(tb.prior_var, jb.prior_var, 1e-4, f"{key} prior_var", rtol=1e-4)
            assert int(tb.count) == int(jb.count)


@pytest.mark.parametrize("update_every", [1, 2])
@pytest.mark.parametrize("seek_mode", ["fixed", "uncertain"])
def test_matrix_runtime_matches_jax_step_by_step(id_setup, seek_mode, update_every):
    """3 ticks over the four default combinations, adoption at step 1:
    each tick's robot state, every combination's distances (NaN on the
    skipped steps with ``update_every`` 2), the adopted object and the
    final beliefs."""
    rt_j, rt_t = matrix_pair(id_setup, seek_mode)
    rs, da, sk, beliefs, draws = jax_step_by_step(rt_j, 3, 4, update_every)
    rt_t.run(3, seed=4, update_every=update_every, draws=draws)
    same_history(rt_t, rs, da, sk, beliefs, update_every)
    if update_every == 2:
        assert np.isnan(da[1]).all()


def test_jax_fused_run_equals_its_step_by_step_composition(id_setup):
    """The JAX runtime's fused scan and the step-by-step body that the port
    is held against give the same run."""
    rt_a, _ = matrix_pair(id_setup, "uncertain", combos=COMBOS[:2])
    rt_b, _ = matrix_pair(id_setup, "uncertain", combos=COMBOS[:2])
    rs, da, sk, beliefs, _ = jax_step_by_step(rt_a, 3, 4, 2)
    rt_b.run(3, seed=4, update_every=2)
    for h in rt_b.history:
        i = h["step"]
        close(h["robot_state"], rs[i], 1e-5)
        assert h["seek_k"] == sk[i]
        for ci, (m, _) in enumerate(COMBOS[:2]):
            close(h[m], da[i, ci], 1e-5, rtol=1e-5)
    for ci, (m, _) in enumerate(COMBOS[:2]):
        for a, b in zip(rt_b.beliefs[m], beliefs[ci]):
            close(a.prior, b.prior, 1e-5)


def test_test_runtime_matches_jax_step_by_step(id_setup):
    """The single-combination runtime (KL) over 3 ticks, adoption at 1."""
    jc, tc, jm, jp, tm, jfs, tfs = id_setup
    combos = (("KL", False),)
    rt_j = jrt.FingerprintTestRuntime(jc, jm, jp, jfs, dist_method="KL", update_tdist_step=1,
                                      beliefs=small_beliefs(jid, jc, jfs, combos)["KL"])
    rt_t = trt.FingerprintTestRuntime(tc, tm, tfs, dist_method="KL", update_tdist_step=1,
                                      beliefs=small_beliefs(tid, tc, tfs, combos,
                                                            device="cpu")["KL"], device="cpu")
    rs, da, sk, beliefs, draws = jax_step_by_step(rt_j, 3, 2, 1)
    _, hist = rt_t.run(3, seed=2, draws=draws)
    for h in hist:
        close(h["dists"], da[h["step"], 0], 1e-4, rtol=1e-4)
        close(h["robot_state"], rs[h["step"]], 1e-4)
    for tb, jb in zip(rt_t.beliefs, beliefs[0]):
        close(tb.prior, jb.prior, 1e-4)
    close(rt_t.belief_peaks(), np.stack([np.asarray(b.grid)[int(np.argmax(b.prior))]
                                         for b in beliefs[0]]), 0.0)


def test_entropies_select_and_target_pdf_match_jax():
    """The entropy ordering, the device select of the largest-entropy
    belief, and the sharpened target pdf."""
    lims = [[-1, 1], [-1, 1]]
    jb = [jbel.FingerprintBelief.create("xy", lims, num_samples=20) for _ in range(3)]
    tb = [tbel.FingerprintBelief.create("xy", lims, num_samples=20, device="cpu")
          for _ in range(3)]
    g = np.asarray(jb[0].grid)
    for i, c in enumerate(([0.5, 0.5], [-0.4, 0.2])):
        p = (0.5 + 0.4 * np.exp(-np.sum((g - c) ** 2, 1) / (0.05 * (i + 1)))).astype(np.float32)
        jb[i] = jb[i].replace(prior=jnp.asarray(p))
        tb[i] = dataclasses.replace(tb[i], prior=t(p))
    jents, tents = jrt._belief_entropies(jb), trt._belief_entropies(tb)
    close(tents, jents, 1e-5, rtol=1e-6)
    k = torch.argmax(tents)
    assert int(k) == int(jnp.argmax(jents)) == 2
    sel = trt._select(tb, k)
    assert torch.equal(sel.prior, tb[2].prior) and torch.equal(sel.grid, tb[2].grid)
    samples = np.random.default_rng(3).uniform(-1, 1, (80, 2)).astype(np.float32)
    for sharp in (1.0, 20.0):
        close(trt._make_target_pdf(sharp)(tb[0], t(samples)),
              jrt._make_target_pdf(sharp)(jb[0], jnp.asarray(samples)), 1e-6, rtol=1e-4)
    flat = trt._make_target_pdf(20.0)(tb[2], t(samples))
    close(flat, np.ones(80), 1e-6)


def test_results_table_and_files_match_jax(id_setup, tmp_path):
    """On the same beliefs, the peaks, errors and saved files agree."""
    rt_j, rt_t = matrix_pair(id_setup, "fixed")
    rng = np.random.default_rng(5)
    for key in rt_t.beliefs:
        for i, (jb, tb) in enumerate(zip(rt_j.beliefs[key], rt_t.beliefs[key])):
            p = rng.uniform(0, 1, tb.prior.shape).astype(np.float32)
            rt_j.beliefs[key][i] = jb.replace(prior=jnp.asarray(p))
            rt_t.beliefs[key][i] = dataclasses.replace(tb, prior=t(p))
    truth = np.array([[0.3, 0.3, 0.0], [-0.3, -0.3, 0.0]], np.float32)
    got, want = rt_t.results_table(truth), rt_j.results_table(truth)
    assert list(got) == list(want) == ["L2", "KL", "BC", "L2_error"]
    for key in want:
        close(got[key]["peaks"], want[key]["peaks"], 0.0)
        close(got[key]["error"], want[key]["error"], 1e-6)
        assert got[key]["mean_error"] == pytest.approx(want[key]["mean_error"], rel=1e-6)
    paths = rt_t.save(str(tmp_path / "port"))
    jpaths = rt_j.save(str(tmp_path / "jax"))
    assert [p.rsplit("/", 1)[1] for p in paths.values()] == \
        [p.rsplit("/", 1)[1] for p in jpaths.values()]
    for key in paths:
        with np.load(paths[key]) as a, np.load(jpaths[key]) as b:
            assert a.files == b.files
            for f in ("grids", "priors", "prior_vars", "lims", "counts"):
                close(a[f], b[f], 0.0, f)


def _count_footprints(monkeypatch):
    calls, costs = [], []
    for name, out in (("traj_footprint", calls), ("traj_spread", calls), ("plan_cost", costs)):
        fn = getattr(tklerg, name)
        monkeypatch.setattr(tklerg, name,
                            lambda *a, _fn=fn, _out=out, **k: _out.append(1) or _fn(*a, **k))
    return calls, costs


def test_k1_calls_per_capture_and_identification_tick(id_setup, monkeypatch):
    """6 footprint calls and 11 cost calls a tick on both paths (the eval
    planner's); none in the matching and fusion. Counted on the CPU by
    wrapping the planner's calls, where the kernels' own counters do not
    move."""
    calls, costs = _count_footprints(monkeypatch)
    _, tc, _, _, tm, _, _ = id_setup
    tcap.capture_fingerprint(tm, tc, np.array([0.1, 0.0, 0.0], np.float32), num_steps=2,
                             device="cpu")
    assert (len(calls), len(costs)) == (12, 22)
    calls.clear()
    costs.clear()
    _, rt_t = matrix_pair(id_setup, "uncertain")
    rt_t.run(3, seed=0)
    assert (len(calls), len(costs)) == (18, 33)


@pytest.mark.parametrize("seek_mode", ["fixed", "uncertain"])
def test_runtime_draws_from_its_generators(id_setup, seek_mode):
    """Without fed draws: finite beliefs and distances, the history's
    shape, and the adopted object in range."""
    _, rt_t = matrix_pair(id_setup, seek_mode, update_tdist_step=2)
    beliefs, hist = rt_t.run(4, seed=1, update_every=2)
    assert [h["step"] for h in hist] == [0, 2] and rt_t.seek_history.shape == (4,)
    for key, bs in beliefs.items():
        assert all(torch.isfinite(b.prior).all() for b in bs)
        assert all(np.isfinite(h[key]).all() and h[key].shape == (2,) for h in hist)
    assert set(rt_t.seek_history.tolist()) <= {0, 1}

"""The fingerprint stage on the arm with learned weights: the captures at
the true object centres, the calibrated thresholds and the identification
runtime, the port against the JAX package.

Both sides take the weights of the JAX toy run of ``test_torch_arm_long``
on ``"arm"`` after its 160 ticks (53 trainer calls). The captures are the
published study's (50 ticks at each true centre, seed k for object k);
the JAX planner's draws are fed to the port tick by tick. Whole captures
run free on both sides; a capture runs no trainer, but its command carries
the measured velocity forward as the tick's does, so a rounding
difference in a pose grows by a constant step a tick (at object 1 from
1e-6 at pose 20 to 1.9e-4 at pose 48). So the whole capture is held at
1e-4 over its first 40 kept poses and 1e-3 over all, and each of its 50
ticks is also held re-synchronised: the port's tick and encoding from the
JAX state before it (``planner_state_from_jax``, ``env_state_from_jax``),
at 1e-4. Each side calibrates its thresholds from its own captures. The
identification runtime's 30 ticks on the arm over the four combinations
(adoption at step 5, both seek modes) are held re-synchronised the same
way, from the JAX evaluation state and beliefs before each tick, on the
JAX captures: the body of the JAX runtime's scan driven step by step, as
``test_torch_fp_runtime.jax_step_by_step`` drives it (the fused run equals
it).

Tolerances: the same kept poses; latents, poses and images 1e-4; the
thresholds and clips rtol 1e-4; the runtime's robot states, distances
(rtol 1e-4) and beliefs 1e-4, its adopted object exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.fingerprint import capture as jcap, identify as jid, test_runtime as jrt
from ealv_tpu.models.cvae import init_model_state, update_dist
from ealv_tpu.runtime.tester import EvalExperiment as JEval
from ealv_tpu.utils.states import ws_conversion as j_ws
from ealv_tpu_torch.fingerprint import capture as tcap, identify as tid, \
    test_runtime as trt
from ealv_tpu_torch.models.cvae import init_model_state as t_init_model_state, \
    update_dist as t_update_dist
from ealv_tpu_torch.runtime.tester import EvalExperiment as TEval
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import env_state_from_jax, params_from_jax, \
    planner_state_from_jax, scene_from_jax
from test_torch_arm_long import toy_run
from test_torch_fingerprint import close
from test_torch_fp_runtime import COMBOS, small_beliefs
from test_torch_tester import jax_plan_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

CAPTURE_STEPS = 50
ID_STEPS = 30
ADOPT = 5
TIGHT = 40


def _plan_draws(ev_exp):
    """The JAX planner's draws at a tick of ``ev_exp``, from its state."""
    cfg = ev_exp.cfg
    return lambda pstate, full_state: jax_plan_draws(
        ev_exp.planner, pstate, full_state, cfg.num_target_samples, cfg.num_traj_samples)


@functools.lru_cache(maxsize=None)
def setup(case="arm"):
    """The JAX run's config, scene, model and final weights; the port's
    config, scene and model with those weights; the true centres."""
    run = toy_run(case)
    es = run.checkpoints["last"][2]
    jc, exp_j = run.exp.cfg, run.exp
    tc = ExperimentConfig(**run.cfg_kw)
    port = run.port()
    tm = port.make_model()
    tm.load_state_dict(params_from_jax(es.params, tm))
    tm.eval()
    scene_j = es.env.scene
    truth = []
    for xy in np.asarray(scene_j.obj_xy):
        full = np.zeros(jc.s_dim, np.float32)
        full[:2] = xy
        truth.append(np.asarray(j_ws(jnp.asarray(full), jnp.asarray(jc.tray_lim),
                                     jnp.asarray(jc.robot_lim))))
    return dict(jc=jc, tc=tc, jm=exp_j.model, jp=es.params, tm=tm, scene_j=scene_j,
                scene_t=scene_from_jax(scene_j, "cpu"), truth=np.stack(truth))


def jax_capture_draws(jc, center, seed, scene, n):
    """The JAX capture's planner draws, tick by tick, from its own
    EvalExperiment started as ``capture_fingerprint`` starts it."""
    target = jcap.make_capture_target(jc.states, center, "sphere")
    ev_exp = JEval(jc, lambda ctx, s: ctx.pdf(s), scene=scene, kernel_std_scale=0.1)
    center_tray = np.asarray(j_ws(jnp.asarray(center), ev_exp.robot_lim, ev_exp.tray_lim))
    pose6 = np.array([(lo + hi) / 2 for lo, hi in ev_exp.env.tray_lim], np.float32)
    for i, s in enumerate(jc.states):
        pose6["xyzrpw".find(s)] = center_tray[i]
    ev = ev_exp.init(start_tray_pose=pose6, seed=seed, shrink_center=jnp.asarray(center))
    ev = ev_exp.use_pose(ev, jnp.asarray(pose6))
    tick = jax.jit(ev_exp.tick)
    plan_draws = _plan_draws(ev_exp)
    draws = []
    for _ in range(n):
        draws.append(plan_draws(ev.pstate, ev_exp._measured(ev.env)))
        ev, _ = tick(ev, target)
    return draws


@functools.lru_cache(maxsize=None)
def captures(case="arm"):
    """(JAX captures, port captures) at the true centres, seed k for object k."""
    s = setup(case)
    fps_j, fps_t = [], []
    for k, center in enumerate(s["truth"]):
        draws = jax_capture_draws(s["jc"], center, k, s["scene_j"], CAPTURE_STEPS)
        fps_j.append(jcap.capture_fingerprint(s["jm"], s["jp"], s["jc"], center,
                                              scene=s["scene_j"], num_steps=CAPTURE_STEPS,
                                              seed=k))
        fps_t.append(tcap.capture_fingerprint(s["tm"], s["tc"], center, scene=s["scene_t"],
                                              num_steps=CAPTURE_STEPS, seed=k, draws=draws,
                                              device="cpu"))
    return fps_j, fps_t


@pytest.mark.parametrize("k", [0, 1])
def test_arm_capture_matches_jax(k):
    """The whole capture at object k's centre, free-running: the same
    poses kept by the greedy filter, the latents and poses at 1e-4 over the
    first 40 kept poses and 1e-3 over all."""
    check_capture("arm", k)


def check_capture(case, k):
    fp_j, fp_t = (fps[k] for fps in captures(case))
    assert fp_t["x"].shape == fp_j["x"].shape, (fp_t["x"].shape, fp_j["x"].shape)
    for key in ("z_mu", "z_var", "x"):
        close(fp_t[key][:TIGHT], fp_j[key][:TIGHT], 1e-4, f"object {k} {key}")
        close(fp_t[key], fp_j[key], 1e-3, f"object {k} {key}")
    close(fp_t["center"], fp_j["center"], 0.0)
    close(fp_t["center_img"], fp_j["center_img"], 1e-5, "center_img")


@pytest.mark.parametrize("method", ["L2", "KL", "BC"])
def test_arm_calibrated_thresholds_match_jax(method):
    """Each side calibrates from its own two captures."""
    check_thresholds("arm", method)


def check_thresholds(case, method):
    fps_j, fps_t = captures(case)
    th_j, cl_j = jid.calibrate_thresholds(jid.FingerprintSet.from_lists(fps_j), method)
    th_t, cl_t = tid.calibrate_thresholds(tid.FingerprintSet.from_lists(fps_t, device="cpu"),
                                          method)
    close(th_t, th_j, 0.0, f"{method} thresh", rtol=1e-4)
    close(cl_t, cl_j, 0.0, f"{method} clip", rtol=1e-4)


def _eval_state(ev_j, like):
    """A JAX ``EvalState`` as the port's, the random stream of ``like``."""
    return dataclasses.replace(like, pstate=planner_state_from_jax(ev_j.pstate, like.pstate),
                               env=env_state_from_jax(ev_j.env, "cpu"), step=int(ev_j.step))


def _belief(jb, like):
    """A JAX ``FingerprintBelief``'s state on the port's ``like``."""
    return dataclasses.replace(like, **{name: torch.tensor(np.asarray(getattr(jb, name)))
                                        for name in ("prior", "prior_var", "meas_loc",
                                                     "meas_val", "meas_n", "count")})


@pytest.mark.parametrize("k", [0, 1])
def test_arm_capture_ticks_resynchronised(k):
    """Each of the 50 capture ticks at object k's centre from the JAX
    state before it: the arm's joints and pose, the encoded observation's
    latents, and the image."""
    check_capture_ticks("arm", k)


def _env_close(env_t, env_j, what):
    close(env_t.pose, env_j.pose, 1e-4, f"{what} env pose")
    if hasattr(env_j, "q"):
        close(env_t.q, env_j.q, 1e-4, f"{what} q")


def check_capture_ticks(case, k):
    s = setup(case)
    jc, center = s["jc"], s["truth"][k]
    ev_exp = JEval(jc, lambda ctx, x: ctx.pdf(x), scene=s["scene_j"], kernel_std_scale=0.1)
    target_j = jcap.make_capture_target(jc.states, center, "sphere")
    pose6 = np.array([(lo + hi) / 2 for lo, hi in ev_exp.env.tray_lim], np.float32)
    pose6[:2] = np.asarray(j_ws(jnp.asarray(center), ev_exp.robot_lim, ev_exp.tray_lim))[:2]
    ev = ev_exp.use_pose(ev_exp.init(start_tray_pose=pose6, seed=k,
                                     shrink_center=jnp.asarray(center)), jnp.asarray(pose6))
    tick = jax.jit(ev_exp.tick)
    encode = jax.jit(lambda rs, y: update_dist(s["jm"], s["jp"], init_model_state(s["jm"]),
                                               rs, y)[1])
    plan_draws = _plan_draws(ev_exp)
    ev_t_exp = TEval(s["tc"], lambda ctx, x: ctx.pdf(x), scene=s["scene_t"],
                     kernel_std_scale=0.1, device="cpu")
    like = ev_t_exp.init(start_tray_pose=pose6, seed=k, shrink_center=center)
    target_t = tcap.make_capture_target(jc.states, center, "sphere", device="cpu")
    mstate = t_init_model_state(s["tm"], "cpu")
    for i in range(CAPTURE_STEPS):
        draws = plan_draws(ev.pstate, ev_exp._measured(ev.env))
        ev2, obs = tick(ev, target_j)
        out = encode(obs["robot_state"], obs["image"])
        ev_t, obs_t = ev_t_exp.tick(_eval_state(ev, like), target_t, draws)
        _, out_t = t_update_dist(s["tm"], mstate, obs_t["robot_state"], obs_t["image"])
        what = f"object {k} capture tick {i}"
        _env_close(ev_t.env, ev2.env, what)
        close(obs_t["robot_state"], obs["robot_state"], 1e-4, f"{what} pose")
        close(obs_t["image"], obs["image"], 1e-4, f"{what} image")
        close(out_t["z_mu"], out["z_mu"], 1e-4, f"{what} z_mu")
        close(out_t["z_logvar"], out["z_logvar"], 1e-4, f"{what} z_logvar")
        ev = ev2


@pytest.mark.parametrize("seek_mode", ["fixed", "uncertain"])
def test_arm_identification_ticks_resynchronised(seek_mode):
    """30 identification ticks on the arm over the four combinations, on
    the JAX captures, adoption at step 5, each from the JAX evaluation
    state and beliefs before it: the robot state, every combination's
    distances, the adopted object and the beliefs after the tick."""
    check_identification_ticks("arm", seek_mode)


def check_identification_ticks(case, seek_mode):
    s = setup(case)
    jc, tc = s["jc"], s["tc"]
    fps_j = captures(case)[0]
    jfs = jid.FingerprintSet.from_lists(fps_j)
    tfs = tid.FingerprintSet.from_lists(fps_j, device="cpu")
    kw = dict(combos=COMBOS, seek_mode=seek_mode, update_tdist_step=ADOPT)
    rt_j = jrt.FingerprintMatrixRuntime(jc, s["jm"], s["jp"], jfs, scene=s["scene_j"],
                                        beliefs=small_beliefs(jid, jc, jfs, COMBOS), **kw)
    rt_t = trt.FingerprintMatrixRuntime(tc, s["tm"], tfs, scene=s["scene_t"], device="cpu",
                                        beliefs=small_beliefs(tid, tc, tfs, COMBOS,
                                                              device="cpu"), **kw)
    plant = "ArmEnv" if case == "arm" else "SyntheticEnv"
    assert type(rt_t._ev.env).__name__ == type(rt_j._ev.env).__name__ == plant
    keys = [rt_t.combo_key(m, e) for m, e in COMBOS]
    templates = [rt_t.beliefs[key][0] for key in keys]
    ev_exp = rt_j._ev
    tick = jax.jit(ev_exp.tick)
    updates = [jax.jit(lambda p, bs, x, y, m=m, e=e: jid.update_beliefs(
        rt_j.model, p, jfs, list(bs), x, y, states=jc.states, robot_lim=jc.robot_lim,
        tray_lim=jc.tray_lim, dist_method=m, error_mode=e)) for m, e in COMBOS]
    entropies = jax.jit(jrt._belief_entropies)
    plan_draws = _plan_draws(ev_exp)
    beliefs = [list(rt_j.beliefs[key]) for key in keys]
    ev = ev_exp.init(seed=7)
    like = rt_t._ev.init(seed=7)
    robot_lim, tray_lim = torch.tensor(tc.robot_lim), torch.tensor(tc.tray_lim)
    for i in range(ID_STEPS):
        beliefs_t = [[_belief(b, like_b) for b in bs] for bs, like_b in zip(beliefs, templates)]
        ev_t = _eval_state(ev, like)
        # the JAX body (test_torch_fp_runtime.jax_step_by_step)
        k = int(jnp.argmax(entropies(beliefs[0]))) if seek_mode == "uncertain" else 0
        seek_b = beliefs[0][k]
        if i < ADOPT:
            seek_b = seek_b.replace(prior=jnp.full_like(seek_b.prior, 0.5),
                                    prior_var=jnp.full_like(seek_b.prior_var, 2.0))
        draws = plan_draws(ev.pstate, ev_exp._measured(ev.env))
        ev, obs = tick(ev, seek_b)
        dists = []
        for ci, upd in enumerate(updates):
            bs, d = upd(s["jp"], tuple(beliefs[ci]), obs["robot_state"], obs["image"])
            beliefs[ci] = list(bs)
            dists.append(np.asarray(d))
        # the port's tick from the JAX state
        ev_t, rs_t, d_t, k_t, *_ = trt._identification_tick(
            rt_t._ev, s["tm"], tfs, tc, COMBOS, beliefs_t, 0, 0, ADOPT, 1, ev_t, robot_lim,
            tray_lim, seek_mode, draws)
        what = f"{seek_mode} tick {i}"
        assert int(k_t) == k, what
        close(rs_t, obs["robot_state"], 1e-4, f"{what} robot state")
        _env_close(ev_t.env, ev.env, what)
        for ci, key in enumerate(keys):
            close(d_t[ci], dists[ci], 1e-4, f"{what} {key} dists", rtol=1e-4)
            for tb, jb in zip(beliefs_t[ci], beliefs[ci]):
                close(tb.prior, jb.prior, 1e-4, f"{what} {key} prior")
                close(tb.prior_var, jb.prior_var, 1e-4, f"{what} {key} prior_var", rtol=1e-4)
                assert int(tb.count) == int(jb.count), what

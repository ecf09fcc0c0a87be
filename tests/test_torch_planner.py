"""Step-matched KL-ergodic planner: the port against the JAX planner.

Both planners get one identical frozen input (target samples, trajectory
history, initial plan, target) and the test compares the target shaping,
the base footprint, one forward/backward/t_app/line-search pass, and the
accepted plan and cost of a whole ``plan_with_inputs`` call, in the form of
tests/test_reference_parity.py::TestPlannerStepMatched with the JAX planner
as the reference. The JAX footprint takes its expansion form on the CPU,
the port its direct differences, so values agree to ~1e-3 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu import control as jc
from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.cvae import init_model_state as j_init_state, update_dist as j_update
from ealv_tpu_torch import control as tc
from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, N, M = 10, 256, 64
T = torch.from_numpy


@pytest.fixture(scope="module")
def frozen():
    rng = np.random.default_rng(42)
    samples = rng.uniform(-1.15, 1.15, (N, 2)).astype(np.float32)
    hist_xy = np.clip(np.cumsum(rng.normal(0.0, 0.05, (M, 2)), 0)
                      + np.array([0.4, -0.4]), -0.9, 0.9)
    hist = np.hstack([hist_xy, rng.normal(0.0, 0.1, (M, 2))]).astype(np.float32)
    u0 = rng.normal(0.0, 0.2, (H, 2)).astype(np.float32)
    mu = np.array([-0.5, 0.3], np.float32)
    var = np.array([0.05, 0.08], np.float32)
    return samples, hist, u0, mu, var


def _jax_planner(pdf_fn, u0, hist):
    dyn = jc.make_dynamics("xy", dt=0.1)
    cfg = jc.KlergConfig(horizon=H, num_target_samples=N, num_traj_samples=M,
                         R=0.5, std=0.05)
    planner = jc.KlergPlanner(cfg, dyn, jc.make_policy("Roll", dyn, H), pdf_fn,
                              "xy", explr_locs=[0, 1])
    lim = jnp.array([[-1.0, 1.0], [-1.0, 1.0]])
    barrier, _ = jc.setup_barrier("xy", lim, lim, [0, 1], barr_weight=5.0)
    ps = planner.init_state(jnp.array([0.5, -0.5, 0.0, 0.0]), lim, barrier,
                            buffer_capacity=256, explr_lim_scale=1.15)
    for h in hist:
        ps = ps._replace(memory=ps.memory.push(jnp.asarray(h)))
    return planner, ps._replace(u=jnp.asarray(u0))


def _torch_planner(pdf_fn, u0, hist):
    dyn = tc.make_dynamics("xy", dt=0.1, device="cpu")
    cfg = tc.KlergConfig(horizon=H, num_target_samples=N, num_traj_samples=M,
                         R=0.5, std=0.05)
    planner = tc.KlergPlanner(cfg, dyn, tc.make_policy("Roll", dyn, H), pdf_fn,
                              "xy", explr_locs=[0, 1], device="cpu")
    lim = torch.tensor([[-1.0, 1.0], [-1.0, 1.0]])
    barrier, _ = tc.setup_barrier("xy", lim, lim, [0, 1], barr_weight=5.0)
    ps = planner.init_state(torch.tensor([0.5, -0.5, 0.0, 0.0]), lim, barrier,
                            buffer_capacity=256, explr_lim_scale=1.15)
    for h in hist:
        ps.memory.push(T(h))
    ps.u = T(u0)
    return planner, ps


@pytest.fixture(scope="module")
def gauss(frozen):
    samples, hist, u0, mu, var = frozen
    jp = _jax_planner(lambda _c, s: jnp.exp(-0.5 * jnp.sum((s - mu) ** 2 / var, -1)),
                      u0, hist)
    tp = _torch_planner(lambda _c, s: torch.exp(-0.5 * ((s - T(mu)) ** 2 / T(var)).sum(-1)),
                        u0, hist)
    return jp, tp


@pytest.fixture(scope="module")
def cvae_target(frozen):
    """The planner's production target: the CVAE's predictive variance,
    seeded from one observation, with the same weights on both sides."""
    samples, hist, u0, _, _ = frozen
    img = (24, 24, 3)
    jm = JCVAE(img_dim=img, z_dim=8, s_dim=2, hidden_dim=(64, 32))
    jparams = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 2)),
                                        jnp.zeros((1, *img)), train=False))(
        jax.random.PRNGKey(1))
    tm = CVAE(img_dim=img, z_dim=8, s_dim=2, hidden_dim=(64, 32))
    tm.load_state_dict(params_from_jax(jparams, tm))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 2).astype(np.float32)
    y = rng.uniform(0, 1, img).astype(np.float32)
    jms, _ = j_update(jm, jparams, j_init_state(jm), jnp.array(x), jnp.array(y))
    tms, _ = update_dist(tm, init_model_state(tm, "cpu"), T(x), T(y))
    jp = _jax_planner(lambda ctx, s: jm.apply(ctx[0], ctx[1], s, method=JCVAE.pdf),
                      u0, hist)
    tp = _torch_planner(lambda ctx, s: ctx[0].pdf(ctx[1], s), u0, hist)
    return jp, tp, (jparams, jms), (tm, tms)


def _close(a, b, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=msg)


def test_target_dist_and_base_footprint(frozen, gauss):
    samples, hist, *_ = frozen
    (jpl, jps), (tpl, tps) = gauss
    p_j, aux_j = jpl._target_dist(None, jps, jnp.asarray(samples), 1.0, with_aux=True)
    p_t, aux_t = tpl._target_dist(None, tps, T(samples), 1.0, with_aux=True)
    _close(p_t, p_j, rtol=1e-3, atol=1e-6)
    _close(aux_t["spread"], aux_j["spread"], rtol=1e-4)
    _close(aux_t["pdf"], aux_j["pdf"], rtol=1e-5, atol=1e-7)
    from ealv_tpu.ops import traj_footprint as jfp
    from ealv_tpu_torch.ops import traj_footprint as tfp
    _close(tfp(T(hist), T(samples), tpl.explr_locs, tpl.std),
           jfp(jnp.asarray(hist), jnp.asarray(samples), jpl.explr_locs, jpl.std),
           rtol=1e-3, atol=1e-5)


def test_prior_target_matches(frozen, gauss):
    samples = frozen[0]
    (jpl, jps), (tpl, tps) = gauss
    _close(tpl._target_dist(None, tps, T(samples), 1.0, use_prior=True),
           jpl._target_dist(None, jps, jnp.asarray(samples), 1.0, use_prior=True),
           rtol=1e-3, atol=1e-6)


def test_forward_backward_tapp_line_search(frozen, gauss):
    """One inner iteration at idx 0: linearizations, costate, t_app and the
    line-search window are step-matched; du at rtol 2e-3."""
    samples, hist, u0, *_ = frozen
    (jpl, jps), (tpl, tps) = gauss
    js, ts = jnp.asarray(samples), T(samples)
    ones = np.ones(M, np.float32)

    p_j = jpl._target_dist(None, jps, js, 1.0)
    p_t = tpl._target_dist(None, tps, ts, 1.0)
    from ealv_tpu.ops import traj_footprint as jfp, renormalize as jrn, cost_norm as jcn
    from ealv_tpu_torch.ops import traj_footprint as tfp, renormalize as trn, cost_norm as tcn
    qb_j = jfp(jnp.asarray(hist), js, jpl.explr_locs, jpl.std, traj_mask=jnp.asarray(ones))
    qb_t = tfp(T(hist), ts, tpl.explr_locs, tpl.std, traj_mask=T(ones))

    ue_j, xs_j, A_j, B_j, db_j, dmu_j = jpl._forward(jps, jps.u, 0)
    ue_t, xs_t, A_t, B_t, db_t, dmu_t = tpl._forward(tps, tps.u, 0)
    for a, b in ((ue_t, ue_j), (xs_t, xs_j), (A_t, A_j), (B_t, B_j), (db_t, db_j),
                 (dmu_t, dmu_j)):
        _close(a, b, rtol=1e-5, atol=1e-6)

    q_j = jrn(qb_j + jfp(xs_j, js, jpl.explr_locs, jpl.std))
    q_t = trn(qb_t + tfp(xs_t, ts, tpl.explr_locs, tpl.std))
    du_j, dj_j = jpl._backward(js, p_j, q_j, xs_j, A_j, B_j, db_j, dmu_j)
    du_t, dj_t = tpl._backward(ts, p_t, q_t, xs_t, A_t, B_t, db_t, dmu_t)
    _close(du_t, du_j, rtol=2e-3, atol=2e-4)
    _close(dj_t, dj_j, rtol=2e-3, atol=2e-4)
    t_app = int(torch.argmin(dj_t))
    assert t_app == int(jnp.argmin(dj_j))

    us_j = jpl._saturate(ue_j + du_j)
    us_t = tpl._saturate(ue_t + du_t)
    pn_j, pn_t = jcn(p_j), tcn(p_t)
    cost_j = lambda u: jpl._cost(jps.dyn, u, js, pn_j, qb_j, jps.barrier)
    cost_t = lambda u: tpl._cost(tps.dyn, u, ts, pn_t, qb_t, tps.barrier)
    J0_j, J0_t = cost_j(jps.u), cost_t(tps.u)
    _close(J0_t, J0_j, rtol=2e-3)
    win_j = jpl._line_search(cost_j, jnp.asarray(t_app), us_j[t_app], jps.u, 0, J0_j)
    from ealv_tpu_torch.control.descent import accept_window, choose_slot
    slot = choose_slot(dj_t, tps.u, ue_t, us_t, 0, max_app_dur=tpl.cfg.max_app_dur)
    assert int(slot.t_app) == t_app
    win_t = accept_window(cost_t(slot.plans), J0_t, slot, ue_t, 0)[:3]
    assert [int(v) for v in win_t] == [int(v) for v in win_j]


def test_batched_cost_matches_jax(frozen, gauss):
    samples, hist, u0, *_ = frozen
    (jpl, jps), (tpl, tps) = gauss
    rng = np.random.default_rng(9)
    us = rng.normal(0, 0.3, (5, H, 2)).astype(np.float32)
    p = np.random.default_rng(10).uniform(0.1, 1, N).astype(np.float32)
    p /= p.sum()
    qb = np.random.default_rng(11).uniform(0, 3, N).astype(np.float32)
    want = jpl._cost(jps.dyn, jnp.asarray(us), jnp.asarray(samples), jnp.asarray(p),
                     jnp.asarray(qb), jps.barrier)
    got = tpl._cost(tps.dyn, T(us), T(samples), T(p), T(qb), tps.barrier)
    _close(got, want, rtol=1e-3)
    single = tpl._cost(tps.dyn, T(us[2]), T(samples), T(p), T(qb), tps.barrier)
    _close(single, want[2], rtol=1e-3)


def _plan_both(frozen, jp, tp, jctx=None, tctx=None):
    samples, hist, *_ = frozen
    (jpl, jps), (tpl, tps) = jp, tp
    ones = np.ones(M, np.float32)
    jfn = jax.jit(lambda ps, ctx, s, h, m: jpl.plan_with_inputs(ps, ctx, s, h, m))
    jps2, jinfo = jfn(jps, jctx, jnp.asarray(samples), jnp.asarray(hist), jnp.asarray(ones))
    tps2, tinfo = tpl.plan_with_inputs(tps, tctx, T(samples), T(hist), T(ones))
    return jps2, jinfo, tps2, tinfo


def _check_plan(jps2, jinfo, tps2, tinfo):
    """Plan u at rtol 2e-3, atol 2e-4; ergodic cost at rtol 2e-3."""
    assert float(np.abs(np.asarray(jps2.u)).max()) > 0  # the plan moved
    _close(tps2.u, jps2.u, rtol=2e-3, atol=2e-4, msg="u")
    _close(tinfo["cost"], jinfo["cost"], rtol=2e-3, msg="cost")
    _close(tps2.last_plan, jps2.last_plan, rtol=2e-3, atol=2e-4, msg="last_plan")
    _close(tinfo["q"], jinfo["q"], rtol=2e-3, atol=1e-5, msg="q")
    _close(tinfo["tdist_spread"], jinfo["tdist_spread"], rtol=1e-4)


def test_plan_with_inputs_gaussian_target(frozen, gauss):
    _check_plan(*_plan_both(frozen, *gauss))


def test_plan_with_inputs_cvae_target(frozen, cvae_target):
    jp, tp, jctx, tctx = cvae_target
    jps2, jinfo, tps2, tinfo = _plan_both(frozen, jp, tp, jctx, tctx)
    _close(tinfo["tdist_pdf"], jinfo["tdist_pdf"], rtol=1e-4, atol=1e-7)
    _check_plan(jps2, jinfo, tps2, tinfo)


@pytest.mark.parametrize("nan", [False, True])
def test_save_update_matches_jax(frozen, gauss, nan):
    """Sync to a measured state near plan point 3: the plan is rolled by
    three and the state pushed; a nan measurement changes nothing."""
    (jpl, jps), (tpl, tps) = gauss
    rng = np.random.default_rng(12)
    lp = np.cumsum(rng.normal(0, 0.1, (H + 1, 4)), 0).astype(np.float32)
    meas = lp[3] + np.float32(0.01)
    if nan:
        meas[1] = np.nan
    jps = jps._replace(last_plan=jnp.asarray(lp))
    tps_in = tc.PlannerState(**{**tps.__dict__, "last_plan": T(lp),
                                "memory": tc.klerg.TrajMemory(tps.memory.buf.clone(),
                                                              tps.memory.pos.clone(),
                                                              tps.memory.size.clone())})
    j2 = jpl.save_update(jps, jnp.asarray(meas))
    t2 = tpl.save_update(tps_in, T(meas))
    _close(t2.u, j2.u, rtol=0, atol=0)
    _close(t2.dyn.x, j2.dyn.x, rtol=1e-6, atol=1e-7)
    _close(t2.memory.buf, j2.memory.buf, rtol=1e-6, atol=1e-7)
    assert int(t2.memory.size) == int(j2.memory.size)


# ---------------------------------------------------------------------------
# Every mode of the planner, step-matched through plan_with_inputs (or plan
# with the JAX draws fed), at the tolerances above; every dynamics model and
# policy in test_torch_planner_models.py, with the helpers below.
STATES = {"single": "xy", "double": "xy", "speed": "xy", "roll": "xyzrpw"}


def _dyns(dyn):
    states = STATES[dyn]
    if dyn == "single":
        kw = dict(num_states=2, num_actions=2, dt=0.1)
        return jc.SingleIntegrator(**kw), tc.SingleIntegrator(**kw, device="cpu")
    kw = dict(dt=0.1, use_magnitude=dyn == "speed")
    return jc.make_dynamics(states, **kw), tc.make_dynamics(states, **kw, device="cpu")


def _scene(dyn, n_state, seed=7):
    """Limits, start state, samples, history, initial plan and target for a
    planner over STATES[dyn]; the roll starts positive, away from the wrap."""
    states = STATES[dyn]
    d = len(states)
    rng = np.random.default_rng(seed)
    lim = np.array([[-0.75, 0.75] if s in "rpw" else [-1.0, 1.0] for s in states], np.float32)
    ctrl = np.array([[-0.5, 0.5] if s in "rp" else [-1.25, 1.25] for s in states], np.float32)
    x0 = np.zeros(n_state, np.float32)
    x0[:d] = rng.uniform(-0.5, 0.5, d)
    if "r" in states:
        x0[states.index("r")] = 0.4
    samples = rng.uniform(lim[:, 0] * 1.15, lim[:, 1] * 1.15, (N, d)).astype(np.float32)
    hist = np.zeros((M, n_state), np.float32)
    hist[:, :d] = np.clip(np.cumsum(rng.normal(0.0, 0.05, (M, d)), 0) + x0[:d],
                          lim[:, 0] * 0.9, lim[:, 1] * 0.9)
    if n_state > d:
        hist[:, d: 2 * d] = rng.normal(0.0, 0.1, (M, d))
    if n_state > 2 * d:  # the speed model's |vel| rows
        hist[:, 2 * d:] = np.abs(hist[:, d: 2 * d])
    u0 = rng.normal(0.0, 0.2, (H, d)).astype(np.float32)
    mu = rng.uniform(lim[:, 0] * 0.6, lim[:, 1] * 0.6).astype(np.float32)
    if "r" in states:
        mu[states.index("r")] = 0.6
    var = rng.uniform(0.05, 0.1, d).astype(np.float32)
    return lim, ctrl, x0, samples, hist, u0, mu, var


def _pair(dyn, policy="Roll", **cfg_kw):
    """(JAX planner, state), (port planner, state), scene for one model,
    policy and config, from the same inputs; the history is pushed into
    both memories."""
    jdyn, tdyn = _dyns(dyn)
    states = STATES[dyn]
    lim, ctrl, x0, samples, hist, u0, mu, var = scene = _scene(dyn, jdyn.num_states)
    kw = dict(horizon=H, num_target_samples=N, num_traj_samples=M, R=0.5, std=0.05, **cfg_kw)
    locs = list(range(len(states)))
    jpl = jc.KlergPlanner(jc.KlergConfig(**kw), jdyn, jc.make_policy(policy, jdyn, H),
                          lambda _c, s: jnp.exp(-0.5 * jnp.sum((s - mu) ** 2 / var, -1)),
                          states, explr_locs=locs)
    tpl = tc.KlergPlanner(tc.KlergConfig(**kw), tdyn, tc.make_policy(policy, tdyn, H),
                          lambda _c, s: torch.exp(-0.5 * ((s - T(mu)) ** 2 / T(var)).sum(-1)),
                          states, explr_locs=locs, device="cpu")
    jb, _ = jc.setup_barrier(states, jnp.asarray(lim), jnp.asarray(ctrl), locs)
    tb, _ = tc.setup_barrier(states, T(lim), T(ctrl), locs)
    if dyn == "single":  # its state holds the positions alone
        jb, tb = jb.truncate(len(states)), tb.truncate(len(states))
    jps = jpl.init_state(jnp.asarray(x0), jnp.asarray(lim), jb, buffer_capacity=256,
                         explr_lim_scale=1.15)
    tps = tpl.init_state(T(x0), T(lim), tb, buffer_capacity=256, explr_lim_scale=1.15)
    for h in hist:
        jps = jps._replace(memory=jps.memory.push(jnp.asarray(h)))
        tps.memory.push(T(h))
    return (jpl, jps._replace(u=jnp.asarray(u0))), (tpl, dataclasses.replace(tps, u=T(u0))), \
        scene


def _plan_pair(jp, tp, scene):
    samples, hist = scene[3], scene[4]
    return _plan_both((samples, hist), jp, tp)


MODES = [dict(full_cost=True), dict(fixed_lam=True), dict(fixed_lam=True, lam=3),
         dict(ctrl_app_search=False)]


@pytest.mark.parametrize("dyn", ["double", "roll"])
@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(f"{k}={v}" for k, v in m.items()))
def test_plan_with_inputs_every_mode(dyn, mode):
    jp, tp, scene = _pair(dyn, **mode)
    _check_plan(*_plan_pair(jp, tp, scene))


def _jax_plan_draws(jpl, jps):
    """The draws the JAX ``plan`` makes from its key: the uniform (and,
    with sample_near_current_loc, the near-current) samples and the
    history draw's indices."""
    cfg = jpl.cfg
    _, k_samp, k_hist = jax.random.split(jps.key, 3)
    lims = jps.lims
    n_uniform = int(cfg.num_target_samples * 0.9) if cfg.sample_near_current_loc \
        else cfg.num_target_samples
    samples = jax.random.uniform(k_samp, (n_uniform, lims.shape[0]),
                                 minval=lims[:, 0], maxval=lims[:, 1])
    if cfg.sample_near_current_loc:
        k_loc, _ = jax.random.split(k_samp)
        near = (jax.random.normal(k_loc, (cfg.num_target_samples - n_uniform, lims.shape[0]))
                * (jpl.std * 4.0) + jps.dyn.x[jpl.explr_locs][None, :])
        samples = jnp.concatenate([samples, near], 0)
    cap = jps.memory.capacity
    logw = jnp.where(jnp.arange(cap) < jps.memory.size, 0.0, -1e30)
    hist_idx = jax.lax.top_k(logw + jax.random.gumbel(k_hist, (cap,)), cfg.num_traj_samples)[1]
    return T(np.array(samples)), torch.tensor(np.asarray(hist_idx), dtype=torch.int64)


@pytest.mark.parametrize("dyn", ["double", "roll"])
@pytest.mark.parametrize("mode", ["add_recent_history", "sample_near_current_loc", "both"])
def test_plan_sampling_modes_match_jax(dyn, mode):
    """``plan`` with the JAX draws fed: the port appends the H most recent
    visited states itself (N + H samples)."""
    kw = dict(add_recent_history=mode != "sample_near_current_loc",
              sample_near_current_loc=mode != "add_recent_history")
    (jpl, jps), (tpl, tps), _ = _pair(dyn, **kw)
    samples, hist_idx = _jax_plan_draws(jpl, jps)
    jps2, jinfo = jax.jit(lambda ps: jpl.plan(ps, None))(jps)
    tps2, tinfo = tpl.plan(tps, None, samples=samples, hist_idx=hist_idx)
    n = N + (H if kw["add_recent_history"] else 0)
    assert tinfo["samples"].shape == (n, len(STATES[dyn]))
    _close(tinfo["samples"], jinfo["samples"], rtol=1e-6, atol=1e-6, msg="samples")
    _check_plan(jps2, jinfo, tps2, tinfo)


def test_forward_linearizes_every_step():
    """The roll model's A follows the angles and R along the horizon; the
    port's per-step (A, B, dbarr, dmu) match the reference's."""
    (jpl, jps), (tpl, tps), _ = _pair("roll", "LQR")
    j = jpl._forward(jps, jps.u, 1)
    t = tpl._forward(tps, tps.u, 1)
    for name, a, b in zip(("u_eff", "xs", "A", "B", "dbarr", "dmu"), t, j):
        _close(a, b, rtol=1e-4, atol=1e-5, msg=name)
    A = t[2]
    assert not torch.equal(A[0], A[-1])  # not linearized once


def test_update_lims_matches_jax():
    (jpl, jps), (tpl, tps), scene = _pair("double")
    new = np.array([[-0.5, 0.2]], np.float32)
    j = jpl.update_lims(jps, [1], jnp.asarray(new), robot_ctrl_lim=jnp.asarray(scene[1]))
    t = tpl.update_lims(tps, [1], T(new), robot_ctrl_lim=T(scene[1]))
    _close(t.lims, j.lims, rtol=0, atol=0)
    _close(t.barrier.b_lim, j.barrier.b_lim, rtol=0, atol=0)
    j = jpl.update_lims(jps, 0, jnp.asarray(new[0]))
    t = tpl.update_lims(tps, 0, T(new[0]))
    _close(t.lims, j.lims, rtol=0, atol=0)
    _close(t.barrier.b_lim, tps.barrier.b_lim, rtol=0, atol=0)


@pytest.mark.parametrize("dyn", ["double", "roll"])
def test_plot_dists_matches_jax(dyn):
    (jpl, jps), (tpl, tps), scene = _pair(dyn)
    samples = scene[3]
    j = jpl.plot_dists(jps, None, jnp.asarray(samples), [0, 1])
    t = tpl.plot_dists(tps, None, T(samples), [0, 1])
    _close(t[0], j[0], rtol=0, atol=0, msg="plot samples")
    _close(t[1], j[1], rtol=1e-3, atol=1e-6, msg="pplot")
    _close(t[2], j[2], rtol=1e-3, atol=1e-5, msg="qplot")


@pytest.mark.parametrize("dyn", ["double", "roll"])
def test_step_matches_jax(dyn):
    """Plan, apply the first control and sync to the predicted state."""
    (jpl, jps), (tpl, tps), _ = _pair(dyn)
    samples, hist_idx = _jax_plan_draws(jpl, jps)
    jout = jax.jit(lambda ps: jpl.step(ps, None, save_update=True))(jps)
    tout = tpl.step(tps, None, save_update=True, samples=samples, hist_idx=hist_idx)
    for name, a, b in zip(("explored state", "velocity", "control"), tout[1:4], jout[1:4]):
        _close(a, b, rtol=2e-3, atol=2e-4, msg=name)
    _close(tout[0].u, jout[0].u, rtol=2e-3, atol=2e-4, msg="u")
    _close(tout[0].dyn.x, jout[0].dyn.x, rtol=2e-3, atol=2e-4, msg="dyn x")
    _close(tout[0].dyn.R, jout[0].dyn.R, rtol=1e-4, atol=1e-5, msg="dyn R")
    assert int(tout[0].memory.size) == int(jout[0].memory.size) == M + 1


@pytest.mark.parametrize("policy", ["Zero", "BarrierPush", "LQR"])
@pytest.mark.parametrize("nan", [False, True])
def test_save_update_roll_and_policies_match_jax(policy, nan):
    """The roll model rebuilds R from the measured angles, and keeps the old
    one for a nan measurement; Zero zeroes the warm start, the others keep
    it."""
    (jpl, jps), (tpl, tps), _ = _pair("roll", policy)
    rng = np.random.default_rng(13)
    lp = np.cumsum(rng.normal(0, 0.05, (H + 1, 12)), 0).astype(np.float32)
    lp[:, 3] += 0.4
    meas = lp[4] + np.float32(0.01)
    if nan:
        meas[5] = np.nan
    j2 = jpl.save_update(jps._replace(last_plan=jnp.asarray(lp)), jnp.asarray(meas))
    t2 = tpl.save_update(dataclasses.replace(tps, last_plan=T(lp)), T(meas))
    _close(t2.u, j2.u, rtol=0, atol=0)
    _close(t2.dyn.x, j2.dyn.x, rtol=1e-6, atol=1e-7)
    _close(t2.dyn.R, j2.dyn.R, rtol=1e-5, atol=1e-6)
    assert int(t2.memory.size) == int(j2.memory.size)

"""Step-matched KL-ergodic planner: the port against the JAX planner.

Both planners get one identical frozen input (target samples, trajectory
history, initial plan, target) and the test compares the target shaping,
the base footprint, one forward/backward/t_app/line-search pass, and the
accepted plan and cost of a whole ``plan_with_inputs`` call, in the form of
tests/test_reference_parity.py::TestPlannerStepMatched with the JAX planner
as the reference. The JAX footprint takes its expansion form on the CPU,
the port its direct differences, so values agree to ~1e-3 relative.
"""

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
    win_t = tpl._line_search(cost_t, torch.tensor(t_app), us_t[t_app], tps.u, 0, J0_t)
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

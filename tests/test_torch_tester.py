"""The evaluation runtime (``runtime/tester.py``) against the JAX
``EvalExperiment``, step-matched over three ticks: the same target (an
``ExplrDist`` mixture, or a frozen CVAE's uncertainty from converted
weights), the planner's draws derived from the JAX keys and fed to the
port. Also the state subset with its re-sliced limits, ``shrink_center``
through the planner's ``update_lims``, ``use_pose``, and the K1 launches a
plan makes (12 here: no coverage spread; 13 in the experiment's tick; 0 in
a baseline's). f32, TF32 off; the tolerances of ``test_torch_tick.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.control.target_dists import ExplrDist as JExplrDist
from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.cvae import init_model_state as j_init_state, update_dist as j_update
from ealv_tpu.runtime.tester import EvalExperiment as JEval
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.control import klerg as tklerg
from ealv_tpu_torch.control.target_dists import ExplrDist
from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
from ealv_tpu_torch.runtime import EvalExperiment, Experiment, TickDraws
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2,
           traj_buffer_capacity=200)


def jax_plan_draws(planner, pstate, full_state, n_samples, n_hist) -> TickDraws:
    """The samples and history indices JAX ``planner.plan`` draws after
    ``save_update(pstate, full_state)``."""

    @jax.jit
    def draws(pstate, full_state):
        ps = planner.save_update(pstate, full_state, save=True)
        _, k_samp, k_hist = jax.random.split(ps.key, 3)
        lims = ps.lims
        samples = jax.random.uniform(k_samp, (n_samples, lims.shape[0]),
                                     minval=lims[:, 0], maxval=lims[:, 1])
        cap = ps.memory.capacity
        logw = jnp.where(jnp.arange(cap) < ps.memory.size, 0.0, -1e30)
        hist_idx = jax.lax.top_k(logw + jax.random.gumbel(k_hist, (cap,)), n_hist)[1]
        return samples, hist_idx

    samples, hist_idx = draws(pstate, full_state)
    return TickDraws(samples=torch.tensor(np.asarray(samples)),
                     hist_idx=torch.tensor(np.asarray(hist_idx), dtype=torch.int64))


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


def _targets(kind, cfg_j, explr_states):
    """(JAX pdf_fn, JAX ctx, port pdf_fn, port ctx) of one target over the
    explored states."""
    d = len(explr_states)
    if kind == "explr":
        rng = np.random.default_rng(3)
        jd, td = JExplrDist.create(8, d), ExplrDist.create(8, d, device="cpu")
        for _ in range(3):
            mean = rng.uniform(-0.6, 0.6, d).astype(np.float32)
            std = rng.uniform(0.02, 0.08, d).astype(np.float32)
            jd = jd.push(jnp.asarray(mean), jnp.asarray(std))
            td = td.push(torch.from_numpy(mean), torch.from_numpy(std))
        return (lambda ctx, s: ctx.pdf(s)), jd, (lambda ctx, s: ctx.pdf(s)), td
    img = cfg_j.image_dim
    jm = JCVAE(img_dim=img, z_dim=cfg_j.z_dim, s_dim=d, hidden_dim=(64, 32))
    jp = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, d)),
                 jnp.zeros((1, *img)), train=False)
    tm = CVAE(img_dim=img, z_dim=cfg_j.z_dim, s_dim=d, hidden_dim=(64, 32))
    tm.load_state_dict(params_from_jax(jp, tm))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, d).astype(np.float32)
    y = rng.uniform(0, 1, img).astype(np.float32)
    js, _ = j_update(jm, jp, j_init_state(jm), jnp.asarray(x), jnp.asarray(y))
    ts, _ = update_dist(tm, init_model_state(tm, "cpu"), torch.from_numpy(x),
                        torch.from_numpy(y))
    return ((lambda ctx, s: jm.apply(ctx[0], ctx[1], s, method=JCVAE.pdf)), (jp, js),
            (lambda ctx, s: ctx[0].pdf(ctx[1], s)), (tm, ts))


def _eval_pair(kind, explr_states=None, **init_kw):
    cfg_j, cfg_t = JConfig(**TOY, compute_dtype="float32"), \
        ExperimentConfig(**TOY, compute_dtype="float32")
    states = explr_states or cfg_t.states
    jfn, jctx, tfn, tctx = _targets(kind, cfg_j, states)
    ej = JEval(cfg_j, jfn, explr_states=explr_states)
    et = EvalExperiment(cfg_t, tfn, explr_states=explr_states, device="cpu")
    start = [0.45, 0.03, 0.35, 3.14, 0.0, 0.2]
    return (ej, ej.init(jnp.asarray(start), seed=2, **init_kw), jctx,
            et, et.init(start, seed=2, **init_kw), tctx)


def _ticks_step_matched(ej, vj, jctx, et, vt, tctx, n=3):
    tick_j = jax.jit(ej.tick)
    cfg = et.cfg
    for k in range(n):
        draws = jax_plan_draws(ej.planner, vj.pstate, ej._measured(vj.env),
                               cfg.num_target_samples, cfg.num_traj_samples)
        vj, oj = tick_j(vj, jctx)
        vt, ot = et.tick(vt, tctx, draws)
        _close(vt.env.pose, vj.env.pose, 1e-4, 1e-5, f"tick {k} env pose")
        _close(ot["robot_state"], oj["robot_state"], 1e-4, 1e-4, f"tick {k} robot state")
        _close(ot["image"], oj["image"], 1e-4, 1e-4, f"tick {k} image")
        _close(ot["force"], oj["force"], 1e-4, 1e-5, f"tick {k} force")
        _close(vt.pstate.u, vj.pstate.u, 2e-3, 2e-4, f"tick {k} plan u")
        _close(ot["cost"], oj["cost"], 2e-3, 0, f"tick {k} cost")
        assert vt.step == int(vj.step) == k + 1
    assert float(vt.pstate.u.abs().max()) > 0  # it planned


@pytest.mark.parametrize("kind", ["explr", "cvae"])
def test_three_eval_ticks_step_matched(kind):
    """Three ticks toward an ExplrDist mixture and toward a frozen CVAE's
    uncertainty: env pose, observation, plan and cost each tick."""
    _ticks_step_matched(*_eval_pair(kind))


def test_state_subset_and_shrink_center_step_matched():
    """explr_states="xy" of states="xyw": the limits re-sliced to x and y,
    the sampling limits and the barrier narrowed around shrink_center, the
    planner's 2-D plan; two ticks."""
    ej, vj, jctx, et, vt, tctx = _eval_pair("explr", "xy", shrink_center=[0.2, -0.1],
                                            shrink_scale=0.3)
    _close(et.explored.robot_lim, ej.robot_lim, 0, 0, "robot_lim")
    _close(et.explored.tray_ctrl_lim, ej.tray_ctrl_lim, 0, 0, "tray_ctrl_lim")
    _close(vt.pstate.lims, vj.pstate.lims, 1e-6, 1e-7, "sampling lims")
    _close(vt.pstate.lims, [[-0.1, 0.5], [-0.4, 0.2]], 1e-6, 1e-7, "shrunk lims")
    _close(vt.pstate.barrier.b_lim, vj.pstate.barrier.b_lim, 1e-6, 1e-7, "barrier lims")
    _close(vt.pstate.dyn.x, vj.pstate.dyn.x, 1e-6, 1e-6, "start state")
    assert vt.pstate.u.shape == (10, 2)  # the horizon, over x and y
    _ticks_step_matched(ej, vj, jctx, et, vt, tctx, n=2)


def test_use_pose_matches_jax():
    """The pose controller, toward a target outside the tray (clipped)."""
    ej, vj, _, et, vt, _ = _eval_pair("explr")
    target = [0.7, -0.05, 0.3, 3.0, 0.1, -0.3]
    vj = ej.use_pose(vj, jnp.asarray(target), n_steps=6)
    vt = et.use_pose(vt, target, n_steps=6)
    _close(vt.env.pose, vj.env.pose, 1e-5, 1e-6, "pose")
    _close(vt.env.vel, vj.env.vel, 1e-4, 1e-5, "vel")
    assert float(vt.env.pose[0]) < 0.625 + 1e-6  # x clipped to the tray


def _count_footprints(monkeypatch):
    """Count the planner's K1 calls (footprint and spread) on the CPU, where
    the kernel's own launch counter does not move."""
    calls = []
    for name in ("traj_footprint", "traj_spread"):
        fn = getattr(tklerg, name)
        monkeypatch.setattr(tklerg, name,
                            lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    return calls


def test_k1_calls_per_plan(monkeypatch):
    """12 per eval plan (base footprint, initial cost, two per each of the
    5 inner iterations), 13 per experiment tick (and the target spread), 0
    per baseline tick."""
    calls = _count_footprints(monkeypatch)
    _, _, _, et, vt, tctx = _eval_pair("explr")
    for _ in range(2):
        vt, _ = et.tick(vt, tctx)
    assert len(calls) == 24
    for method, want in (("entklerg", 13), ("randomWalk", 0), ("uniform", 0)):
        calls.clear()
        exp = Experiment(ExperimentConfig(**TOY, explr_method=method, compute_dtype="float32"),
                         train_calls_per_tick=0, device="cpu")
        es = exp.init(seed=0)
        for _ in range(2):
            es, _ = exp.tick(es)
        assert len(calls) == 2 * want, method


@pytest.mark.parametrize("kwargs", [dict(states="xyXY")])
def test_unported_eval_configurations_raise(kwargs):
    with pytest.raises(NotImplementedError):
        EvalExperiment(ExperimentConfig(**{**TOY, **kwargs}), lambda c, s: s[:, 0],
                       device="cpu")


def test_explr_states_outside_the_states_are_rejected():
    with pytest.raises(ValueError, match="explr_states"):
        EvalExperiment(ExperimentConfig(**TOY), lambda c, s: s[:, 0], explr_states="xz",
                       device="cpu")


def test_brightness_state_runs_where_the_reference_fails():
    """With b among the explored states the JAX EvalExperiment fails in
    init (its start pose has no b slot: shapes (3,) and (4,)); the port
    starts b at mid-range, as the Experiment does, and its ticks command
    the brightness."""
    cfg_j = JConfig(**{**TOY, "states": "xywb"})
    with pytest.raises(TypeError):
        JEval(cfg_j, lambda c, s: s[:, 0]).init()
    _, _, tfn, tctx = _targets("explr", cfg_j, "xywb")
    et = EvalExperiment(ExperimentConfig(**{**TOY, "states": "xywb"}), tfn, device="cpu")
    vt = et.init()
    torch.testing.assert_close(vt.pstate.dyn.x[3], torch.tensor(0.0))  # b mid-range
    for _ in range(2):
        vt, obs = et.tick(vt, tctx)
    assert obs["robot_state"].shape == (4,) and torch.isfinite(obs["cost"])
    assert float(vt.env.brightness) != 1.0  # the planner's b commanded it

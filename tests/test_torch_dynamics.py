"""The port's planner dynamics against ``ealv_tpu/control/dynamics.py``:
every model stepped over a 10-step horizon from the same states and
controls (the port batched over three rollouts, JAX one at a time),
comparing x, R and the linearization (A, B) at every step, and R's
orthonormality. float32 on both sides; rtol 1e-5, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.control import dynamics as jd
from ealv_tpu_torch.control import dynamics as td
from test_torch_trainer import one_torch_thread  # noqa: F401

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-6)
H, K = 10, 3


def _models(name):
    """(jax model, port model, number of x0 entries to set)."""
    if name == "single":
        kw = dict(num_states=3, num_actions=3, dt=0.1)
        return jd.SingleIntegrator(**kw), td.SingleIntegrator(**kw, device="cpu"), 3
    if name == "double":
        return jd.make_dynamics("xyw", dt=0.1), td.make_dynamics("xyw", 0.1, device="cpu"), 6
    if name == "double_euler":
        kw = dict(dt=0.2, use_rk4=False)
        return jd.make_dynamics("xy", **kw), td.make_dynamics("xy", **kw, device="cpu"), 4
    if name in ("speed", "speed_full_x0"):
        kw = dict(dt=0.1, use_magnitude=True)
        return (jd.make_dynamics("xyz", **kw), td.make_dynamics("xyz", **kw, device="cpu"),
                6 if name == "speed" else 9)
    if name == "roll":
        return (jd.make_dynamics("xyzrpw", 0.2), td.make_dynamics("xyzrpw", 0.2, device="cpu"),
                12)
    if name == "roll_rpw_first_scaled":
        kw = dict(dt=0.1, angle_scale=(0.8, 1.2, 1.0), angle_shift=(3.14, 0.0, -0.2))
        return jd.make_dynamics("rpwx", **kw), td.make_dynamics("rpwx", **kw, device="cpu"), 8
    raise KeyError(name)


MODELS = ["single", "double", "double_euler", "speed", "speed_full_x0", "roll",
          "roll_rpw_first_scaled"]


def _inputs(jdyn, n0, seed):
    rng = np.random.default_rng(seed)
    m = jdyn.num_actions
    x0 = rng.uniform(-0.5, 0.5, (K, n0)).astype(np.float32)
    if isinstance(jdyn, jd.DoubleIntegratorRoll):
        # start with a positive roll that stays away from the [0, 2pi) wrap
        x0[:, jdyn.rpw[0]] = rng.uniform(0.4, 0.6, K)
    us = rng.normal(0.0, 0.3, (K, H, m)).astype(np.float32)
    return x0, us


def _close(got, want, msg, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg, **(tol or TOL))


def _orthonormal_err(R):
    eye = torch.eye(3).expand_as(R)
    return float((R.transpose(-1, -2) @ R - eye).abs().max())


@pytest.mark.parametrize("name", MODELS)
def test_horizon_rollout_matches_jax(name):
    jdyn, tdyn, n0 = _models(name)
    x0, us = _inputs(jdyn, n0, MODELS.index(name))
    assert tdyn.state_dependent == isinstance(
        jdyn, (jd.DoubleIntegratorSpeed, jd.DoubleIntegratorRoll))
    ts = [tdyn.init(T(x0[k])) for k in range(K)]
    s = td.DynState(x=torch.stack([a.x for a in ts]), R=torch.stack([a.R for a in ts]))
    js = [jdyn.init(jnp.asarray(x0[k])) for k in range(K)]
    for k in range(K):
        _close(ts[k].x, js[k].x, f"init x {k}")
        _close(ts[k].R, js[k].R, f"init R {k}")
    for t in range(H):
        A, B = tdyn.get_lin(s, T(us[:, t]))
        for k in range(K):
            jA, jB = jdyn.get_lin(js[k], jnp.asarray(us[k, t]))
            _close(A if A.ndim == 2 else A[k], jA, f"A step {t} rollout {k}")
            _close(B if B.ndim == 2 else B[k], jB, f"B step {t} rollout {k}")
        s = tdyn.step(s, T(us[:, t]))
        js = [jdyn.step(js[k], jnp.asarray(us[k, t])) for k in range(K)]
        for k in range(K):
            _close(s.x[k], js[k].x, f"x step {t} rollout {k}")
            _close(s.R[k], js[k].R, f"R step {t} rollout {k}")
    assert _orthonormal_err(s.R) < 1e-5
    if isinstance(tdyn, td.DoubleIntegratorSpeed):
        m = tdyn.num_actions
        assert torch.equal(s.x[:, 2 * m:], s.x[:, m: 2 * m].abs())


def test_roll_carries_rotation_and_wraps_roll():
    """A roll rate that takes the roll through zero: the port's angles jump
    to near 2pi as the reference's do, and R stays orthonormal."""
    jdyn, tdyn, _ = _models("roll")
    x0 = np.zeros(12, np.float32)
    x0[3] = 0.05
    x0[9] = -1.0  # roll rate
    s, js = tdyn.init(T(x0)), jdyn.init(jnp.asarray(x0))
    u = np.zeros(6, np.float32)
    for _ in range(H):
        s, js = tdyn.step(s, T(u)), jdyn.step(js, jnp.asarray(u))
    assert float(s.x[3]) > 4.0  # -1.95 wrapped into [0, 2pi)
    _close(s.x, js.x, "x after the wrap", rtol=1e-5, atol=1e-5)
    _close(s.R, js.R, "R after the wrap")
    assert _orthonormal_err(s.R) < 1e-5


@pytest.mark.parametrize("kw", [dict(states="xyzrpw"), dict(states="xyw"),
                                dict(states="xyz", use_magnitude=True),
                                dict(states="xyzrpw", use_magnitude=True)])
def test_make_dynamics_picks_the_same_model(kw):
    jdyn = jd.make_dynamics(dt=0.1, **kw)
    tdyn = td.make_dynamics(dt=0.1, device="cpu", **kw)
    assert type(tdyn).__name__ == type(jdyn).__name__
    assert (tdyn.num_states, tdyn.num_actions) == (jdyn.num_states, jdyn.num_actions)
    if isinstance(jdyn, jd.DoubleIntegratorRoll):
        assert tdyn.rpw == jdyn.rpw


def test_roll_needs_all_three_angles():
    with pytest.raises(ValueError):
        td.make_dynamics("xrp", 0.1, device="cpu")

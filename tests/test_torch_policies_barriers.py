"""The port's policies, barriers and target distributions against the JAX
package (``ealv_tpu/control/{policies,barrier,target_dists}.py``) on the
same inputs. The port takes batches of states where JAX takes one state
at a time. float32 on both sides; rtol 1e-5, atol 1e-6 unless a case says
otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu import control as jc
from ealv_tpu_torch import control as tc

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **(tol or TOL))


def _dyn_pair(name):
    if name == "double":
        return jc.make_dynamics("xy", 0.1), tc.make_dynamics("xy", 0.1, device="cpu")
    if name == "speed":
        kw = dict(dt=0.1, use_magnitude=True)
        return jc.make_dynamics("xy", **kw), tc.make_dynamics("xy", **kw, device="cpu")
    if name == "roll":
        return jc.make_dynamics("xyzrpw", 0.1), tc.make_dynamics("xyzrpw", 0.1, device="cpu")
    kw = dict(num_states=2, num_actions=2, dt=0.1)
    return jc.SingleIntegrator(**kw), tc.SingleIntegrator(**kw, device="cpu")


def _states(n, m, rows=12, seed=0):
    """States with positions at, inside and beyond the +-1 bounds and
    velocities of both signs and zero."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (rows, n)).astype(np.float32)
    x[: rows // 2, :m] = rng.choice([-1.2, -1.0, 1.0, 1.3], (rows // 2, m))
    x[::3, m: 2 * m] = 0.0
    return x


POLICIES = [("Roll", "double"), ("Zero", "double"), ("BarrierPush", "double"),
            ("BarrierPush", "speed"), ("LQR", "double"), ("LQR", "speed"), ("LQR", "roll"),
            ("LQR", "single")]


@pytest.mark.parametrize("name,dyn", POLICIES)
def test_policy_act_and_dx_match_jax(name, dyn):
    jdyn, tdyn = _dyn_pair(dyn)
    jp, tp = jc.make_policy(name, jdyn, 10), tc.make_policy(name, tdyn, 10)
    assert type(tp).__name__ == type(jp).__name__
    n, m = jdyn.num_states, jdyn.num_actions
    x = _states(n, m, seed=POLICIES.index((name, dyn)))
    u = np.random.default_rng(1).normal(size=(x.shape[0], m)).astype(np.float32)
    got_u, got_dx = tp.act(T(x), T(u)), tp.dx(T(x), T(u))
    assert got_u.shape == u.shape and got_dx.shape == (x.shape[0], m, n)
    if name == "LQR":
        # K from scipy in f64 on both sides, from linearizations equal to 1e-6
        _close(tp.K, np.asarray(jp.K, np.float32), rtol=1e-4, atol=1e-7)
    tol = dict(rtol=1e-4, atol=1e-6) if name == "LQR" else TOL
    for k in range(x.shape[0]):
        _close(got_u[k], jp.act(jnp.asarray(x[k]), jnp.asarray(u[k])), f"act {k}", **tol)
        _close(got_dx[k], jp.dx(jnp.asarray(x[k]), jnp.asarray(u[k])), f"dx {k}", **tol)


@pytest.mark.parametrize("name", ["Roll", "Zero", "BarrierPush", "LQR"])
@pytest.mark.parametrize("idx", [-3, -1, 0, 2])
def test_policy_shift_matches_jax(name, idx):
    """Python ints as the JAX policies take them, and () int tensors as the
    port's planner passes them."""
    jdyn, tdyn = _dyn_pair("double")
    jp, tp = jc.make_policy(name, jdyn, 5), tc.make_policy(name, tdyn, 5)
    u = np.arange(10, dtype=np.float32).reshape(5, 2) + 1.0
    want = np.asarray(jp.shift(jnp.asarray(u), idx))
    _close(tp.shift(T(u), idx), want, rtol=0, atol=0)
    _close(tp.shift(T(u), torch.tensor(idx)), want, rtol=0, atol=0)


def test_unknown_policy_raises():
    with pytest.raises(ValueError):
        tc.make_policy("Greedy", tc.make_dynamics("xy", 0.1, device="cpu"), 10)


# ---------------------------------------------------------------- barriers
def _barrier_pair(kind):
    lim = np.array([[-1.0, 1.0], [-1.0, 1.0], [-1.25, 1.25], [-1.25, 1.25]], np.float32)
    jb, _ = jc.setup_barrier("xy", jnp.asarray(lim[:2]), jnp.asarray(lim[2:]), [0, 1])
    tb, _ = tc.setup_barrier("xy", T(lim[:2]), T(lim[2:]), [0, 1])
    if kind == "tilt":
        jb = jc.TiltBarrierFunction(inner=jb, r_idx=0, p_idx=1)
        tb = tc.TiltBarrierFunction(inner=tb, r_idx=0, p_idx=1)
    elif kind == "tilt_scaled":
        kw = dict(r_idx=1, p_idx=0, tilt_lim=2.0, angle_scale=(0.8, 1.2), angle_shift=(3.1, 0.1))
        jb = jc.TiltBarrierFunction(inner=jb, **kw)
        tb = tc.TiltBarrierFunction(inner=tb, **kw)
    elif kind == "none":
        jb, _ = jc.setup_barrier("xy", jnp.asarray(lim[:2]), jnp.asarray(lim[2:]), [0, 1],
                                 use_barrier=False)
        tb, _ = tc.setup_barrier("xy", T(lim[:2]), T(lim[2:]), [0, 1], use_barrier=False)
    return jb, tb


def _barrier_states(kind):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.6, 1.6, (16, 4)).astype(np.float32)
    if kind.startswith("tilt"):
        x[:8, :2] = rng.uniform(-3.5, 3.5, (8, 2))
        # at the cone's edge: tilt = arccos(cos r cos 0) = 2.45, and just inside/outside
        x[8:11, 0] = np.float32([2.45, 2.45 - 1e-3, 2.45 + 1e-3])
        x[8:11, 1] = 0.0
    return x


BARRIERS = ["box", "tilt", "tilt_scaled", "none"]


@pytest.mark.parametrize("kind", BARRIERS)
def test_barrier_value_and_gradient_match_jax(kind):
    jb, tb = _barrier_pair(kind)
    x = _barrier_states(kind)
    got_b, got_g = tb.barr(T(x)), tb.dbarr(T(x))
    assert got_b.shape == (16,) and got_g.shape == (16, 4)
    _close(tb.batch(T(x.reshape(2, 8, 4))).reshape(-1), got_b, rtol=0, atol=0)
    # (tilt - lim)^4 near the edge and arccos' slope: f32 rounding at 1e-4 relative
    tol = dict(rtol=1e-4, atol=1e-6) if kind.startswith("tilt") else TOL
    for k in range(16):
        _close(got_b[k], jb.barr(jnp.asarray(x[k])), f"barr {k}", **tol)
        _close(got_g[k], jb.dbarr(jnp.asarray(x[k])), f"dbarr {k}", **tol)
    if kind == "tilt":
        assert float(got_b[8]) == pytest.approx(float(tb.inner.barr(T(x[8]))))


@pytest.mark.parametrize("kind", BARRIERS)
def test_barrier_update_lims_and_truncate_match_jax(kind):
    jb, tb = _barrier_pair(kind)
    new = np.array([[-0.5, 0.4], [-0.3, 0.7], [-1.0, 1.0], [-0.2, 0.2]], np.float32)
    x = _barrier_states(kind)
    for jb2, tb2 in ((jb.update_lims(jnp.asarray(new)), tb.update_lims(T(new))),
                     (jb.truncate(2), tb.truncate(2)),
                     (jb.update_lims(jnp.asarray(new), b_buff=0.05).truncate(3),
                      tb.update_lims(T(new), b_buff=0.05).truncate(3))):
        assert type(tb2) is type(tb)
        tol = dict(rtol=1e-4, atol=1e-6) if kind.startswith("tilt") else TOL
        for k in range(16):
            _close(tb2.barr(T(x[k])), jb2.barr(jnp.asarray(x[k])), f"barr {k}", **tol)
            _close(tb2.dbarr(T(x[k])), jb2.dbarr(jnp.asarray(x[k])), f"dbarr {k}", **tol)
    # the original is unchanged
    _close(tb.barr(T(x)), np.stack([jb.barr(jnp.asarray(r)) for r in x]),
           rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("pos,vel", [(True, False), (False, True), (True, True)])
def test_setup_barrier_flags_match_jax(pos, vel):
    lim, ctrl = np.ones((3, 2), np.float32) * [-1, 1], np.ones((3, 2), np.float32) * [-2, 2]
    jb, jl = jc.setup_barrier("xyw", jnp.asarray(lim), jnp.asarray(ctrl), [0, 1, 2],
                              position_barrier=pos, velocity_barrier=vel, barr_weight=3.0)
    tb, tl = tc.setup_barrier("xyw", T(lim), T(ctrl), [0, 1, 2], position_barrier=pos,
                              velocity_barrier=vel, barr_weight=3.0)
    _close(tl, jl, rtol=0, atol=0)
    for f in ("b_lim", "barr_weight", "power"):
        _close(getattr(tb, f), getattr(jb, f), f, rtol=0, atol=0)


# ---------------------------------------------------------------- target dists
def test_gaussian_and_uniform_dists_match_jax():
    s = np.random.default_rng(4).uniform(-1, 1, (50, 3)).astype(np.float32)
    jg = jc.gaussian_dist([0.1, -0.2, 0.3], [0.05, 0.1, 0.2], floor=1e-4)
    tg = tc.gaussian_dist([0.1, -0.2, 0.3], [0.05, 0.1, 0.2], floor=1e-4, device="cpu")
    _close(tg.pdf(T(s)), jg.pdf(jnp.asarray(s)))
    _close(tc.UniformDist(3).pdf(T(s)), jc.UniformDist(3).pdf(jnp.asarray(s)))


@pytest.mark.parametrize("invert", [False, True])
def test_explr_dist_matches_jax(invert):
    """Uniform before any push, then the mean of the pushed Gaussians, also
    once the ring is full (capacity 3, five pushes)."""
    rng = np.random.default_rng(5)
    s = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    jd = jc.ExplrDist.create(3, 2, invert=invert)
    td = tc.ExplrDist.create(3, 2, invert=invert, device="cpu")
    _close(td.pdf(T(s)), jd.pdf(jnp.asarray(s)))
    for i in range(5):
        mean = rng.uniform(-1, 1, 2).astype(np.float32)
        std = rng.uniform(0.05, 0.3, 2).astype(np.float32)
        jd, td2 = jd.push(jnp.asarray(mean), jnp.asarray(std)), td.push(T(mean), T(std))
        assert int(td.size) == min(i, 3)  # push returns a new ring
        td = td2
        _close(td.means, jd.means, rtol=0, atol=0)
        _close(td.stds, jd.stds, rtol=0, atol=0)
        assert int(td.size) == int(jd.size)
        _close(td.pdf(T(s)), jd.pdf(jnp.asarray(s)), f"push {i}")

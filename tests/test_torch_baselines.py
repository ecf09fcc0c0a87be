"""The port's baseline explorers (``control/baselines.py``) against the JAX
``BaselineController``.

Step-matched: each JAX step's uniform draws are derived from its key with
``jax.random`` and fed to the port as ``BaselineDraws``; states,
velocities and the visited-state ring then agree to f32 rounding (rtol
1e-6, atol 1e-6). Also: the bounds over many steps, the stuck teleport,
the first-valid select and the NaN guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.control.baselines import BaselineController as JBaseline
from ealv_tpu_torch.control.baselines import BaselineController, BaselineDraws
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_trainer import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(method, states):
    cfg = ExperimentConfig(states=states)
    lims = tuple(map(tuple, cfg.robot_lim.tolist()))
    ctrl = tuple(map(tuple, cfg.robot_ctrl_lim.tolist()))
    jb = JBaseline(method=method, dt=cfg.dt, robot_lim=lims, robot_ctrl_lim=ctrl,
                   buffer_capacity=16)
    tb = BaselineController(method, cfg.dt, lims, ctrl, buffer_capacity=16, device="cpu")
    return jb, tb


def jax_draws(jb, bs) -> BaselineDraws:
    """The unit draws JAX's ``step`` takes from ``bs.key``."""
    _, k1, k2 = jax.random.split(bs.key, 3)
    n = jb.n_pos
    t = lambda a: torch.tensor(np.asarray(a))
    if jb.method == "randomWalk":
        return BaselineDraws(cands=t(jax.random.uniform(k1, (jb.n_trials, n))),
                             state_u=t(jax.random.uniform(k2, (n,))))
    return BaselineDraws(cands=None, state_u=t(jax.random.uniform(k1, (n,))))


def _close(a, b, what):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=what, **TOL)


@pytest.mark.parametrize("method", ["randomWalk", "uniform"])
@pytest.mark.parametrize("states", ["xyw", "xywb"])
def test_steps_match_jax_with_fed_draws(method, states):
    """Eight steps, each after a save_update with a measured state (the
    fourth a NaN measurement): state, velocity, full state and the
    visited-state ring."""
    jb, tb = _pair(method, states)
    n = jb.n_pos
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    js = jb.init_state(jnp.asarray(x0), seed=3)
    ts = tb.init_state(torch.from_numpy(x0), seed=3)
    step_j = jax.jit(jb.step)
    save_j = jax.jit(jb.save_update)
    for k in range(8):
        meas = rng.uniform(-0.9, 0.9, 2 * n).astype(np.float32)
        if k == 3:
            meas[1] = np.nan
        js = save_j(js, jnp.asarray(meas))
        ts = tb.save_update(ts, torch.from_numpy(meas))
        _close(ts.x, js.x, f"step {k} synced x")
        draws = jax_draws(jb, js)
        js, full_j, vel_j = step_j(js)
        ts, full_t, vel_t = tb.step(ts, draws)
        _close(ts.x, js.x, f"step {k} x")
        _close(ts.last_vel, js.last_vel, f"step {k} last_vel")
        _close(full_t, full_j, f"step {k} full state")
        _close(vel_t, vel_j, f"step {k} vel")
    _close(ts.memory.buf, js.memory.buf, "visited ring")
    assert int(ts.memory.size) == int(js.memory.size) == 7  # the NaN one is not kept


def test_stuck_random_walk_teleports_as_jax():
    """At the upper corner with the last velocity at its upper limit every
    candidate leaves the buffered box: the step teleports to the uniform
    draw with the clipped finite difference as its velocity."""
    jb, tb = _pair("randomWalk", "xyw")
    n = jb.n_pos
    hi = np.asarray(jb.robot_lim, np.float32)[:, 1]
    vmax = np.asarray(jb.robot_ctrl_lim, np.float32)[:, 1]
    js = jb.init_state(jnp.asarray(hi), seed=5)._replace(last_vel=jnp.asarray(vmax))
    ts = tb.init_state(torch.from_numpy(hi), seed=5)
    ts.last_vel = torch.from_numpy(vmax)
    draws = jax_draws(jb, js)
    js, full_j, _ = jax.jit(jb.step)(js)
    ts, full_t, _ = tb.step(ts, draws)
    _close(full_t, full_j, "teleport")
    lo_hi = tb.lims
    want = draws.state_u * (lo_hi[:, 1] - lo_hi[:, 0]) + lo_hi[:, 0]
    _close(ts.x, want.numpy(), "teleport target")
    assert torch.all(ts.last_vel.abs() <= tb.ctrl[:, 1])
    assert n == 3


def test_first_valid_candidate_wins():
    """Candidate 0 leaves the box, 1 and 2 stay inside: 1 is taken."""
    _, tb = _pair("randomWalk", "xy")
    ts = tb.init_state(torch.tensor([0.9, 0.0]))
    cands = torch.full((10, 2), 0.5)  # zero control
    cands[0] = torch.tensor([1.0, 0.5])  # +1.25 in x: leaves the box
    cands[1] = torch.tensor([0.3, 0.5])
    cands[2] = torch.tensor([0.1, 0.5])
    ts, full, vel = tb.step(ts, BaselineDraws(cands=cands, state_u=torch.zeros(2)))
    want_vel = (cands[1] * 2.5 - 1.25) / 2.0
    torch.testing.assert_close(vel, want_vel)
    torch.testing.assert_close(ts.x, torch.tensor([0.9, 0.0]) + want_vel * tb.dt)


@pytest.mark.parametrize("method", ["randomWalk", "uniform"])
def test_own_draws_stay_in_bounds(method):
    """200 steps from the controller's own generator: positions inside the
    workspace, velocities inside the control limits, and the same steps
    again from the same seed."""
    _, tb = _pair(method, "xywb")
    runs = []
    for _ in range(2):
        ts = tb.init_state(torch.zeros(4), seed=11)
        xs = []
        for _ in range(200):
            ts = tb.save_update(ts, torch.cat([ts.x, ts.last_vel]))
            ts, full, vel = tb.step(ts)
            xs.append(full)
        runs.append(torch.stack(xs))
    xs = runs[0]
    assert torch.equal(runs[0], runs[1])
    assert torch.all(xs[:, :4] >= tb.lims[:, 0]) and torch.all(xs[:, :4] <= tb.lims[:, 1])
    assert torch.all(xs[:, 4:] >= tb.ctrl[:, 0]) and torch.all(xs[:, 4:] <= tb.ctrl[:, 1])
    assert float(xs[:, 0].std()) > 0.05  # it explores


def test_nan_measurement_is_not_taken():
    jb, tb = _pair("uniform", "xy")
    js = jb.init_state(jnp.asarray([0.1, 0.2]))
    ts = tb.init_state(torch.tensor([0.1, 0.2]))
    meas = np.array([0.3, np.nan, 0.0, 0.0], np.float32)
    js = jb.save_update(js, jnp.asarray(meas))
    ts = tb.save_update(ts, torch.from_numpy(meas))
    _close(ts.x, js.x, "x")
    assert int(ts.memory.size) == int(js.memory.size) == 0
    torch.testing.assert_close(ts.x, torch.tensor([0.1, 0.2]))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown baseline"):
        BaselineController("spiral", 0.2, ((-1, 1),), ((-1, 1),), device="cpu")

"""The port's kinematic arm (``ealv_tpu_torch/sim/arm.py``) against the JAX
package's ``ealv_tpu/sim/arm.py`` on the same numpy inputs: forward
kinematics, the Jacobian (also against autograd), IK, ``init`` on both
sides of roll = pi, 30 velocity steps through the drift correction at step
20 on each backend, pose control, the contact force and wrench, and
``observe``. f32 on both sides; the JAX steps run jitted, the port's
eagerly on the CPU.

Tolerances: kinematics and contact at 1e-5 (the same f32 formulas; the
port's chain multiplies 4x4 matrices in another order of summation), IK
and step sequences at 2e-5 on joints and poses (the damped solves round
differently: Cholesky here, LU there), images at 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.runtime.watchdog import StuckDetector
from ealv_tpu.sim import arm as ja
from ealv_tpu.sim.renderer import TrayScene as JScene
from ealv_tpu.utils.config import TRAY_LIM
from ealv_tpu_torch.sim import arm as ta
from ealv_tpu_torch.sim.renderer import TrayScene
from ealv_tpu_torch.utils.convert import arm_state_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

TRAY6 = tuple(TRAY_LIM[s] for s in "xyzrpw")
DOWN = [0.45, 0.0, 0.3, np.pi, 0.0, 0.0]
BACKENDS = {"arm": {}, "arm-dynamic": dict(dynamic_contact=True, obj_mobility=0.2),
            "arm-dynamic-soft": dict(dynamic_contact=True, soft_objects=True)}
T = lambda a: torch.tensor(np.asarray(a, np.float32))


def envs(**kw):
    kw.setdefault("img_hw", (16, 16))
    return (ja.ArmEnv(tray_lim=TRAY6, dt=0.04, **kw),
            ta.ArmEnv(tray_lim=TRAY6, dt=0.04, device="cpu", **kw))


def big_cylinder():
    """One wide cylinder reaching well into the z band (the wedge scene of
    tests/test_arm.py), as JAX and port scenes."""
    xy, r, h = [[0.45, 0.0], [0.95, 0.95]], [0.08, 0.01], [0.45, 0.01]
    js = JScene.default()._replace(obj_xy=jnp.array(xy, jnp.float32),
                                   obj_radius=jnp.array(r, jnp.float32),
                                   obj_height=jnp.array(h, jnp.float32))
    ts = TrayScene.default("cpu")._replace(obj_xy=T(xy), obj_radius=T(r), obj_height=T(h))
    return js, ts


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=tol, atol=tol, err_msg=what)


QS = [ja.Q_HOME, ja.Q_HOME + 0.1, jnp.asarray(np.random.default_rng(0).uniform(
    ja.Q_MIN, ja.Q_MAX).astype(np.float32))]


@pytest.mark.parametrize("i", range(len(QS)))
def test_fk_and_jacobian_match_jax(i):
    q = QS[i]
    p, R = ja.fk(q)
    pt, Rt = ta.fk(T(q))
    close(pt, p, 1e-5, "p")
    close(Rt, R, 1e-5, "R")
    close(ta.geometric_jacobian(T(q)), ja.geometric_jacobian(q), 1e-5, "J")


def test_jacobian_matches_autograd():
    """The linear rows are d p_ee / d q (autograd through the port's own
    chain); the angular rows are the frames' z axes, which the position
    alone does not give, so they are held against JAX above."""
    q = T(ja.Q_HOME + 0.1).double()
    Jad = torch.autograd.functional.jacobian(lambda q: ta.fk(q)[0], q)
    np.testing.assert_allclose(ta.geometric_jacobian(q)[:3].numpy(), Jad.numpy(), atol=1e-10)


@pytest.mark.parametrize("iters", [1, 5, 100])
def test_solve_ik_matches_jax(iters):
    want = ja.solve_ik(ja.Q_HOME, jnp.asarray(DOWN, jnp.float32), iters=iters)
    got = ta.solve_ik(T(ja.Q_HOME), T(DOWN), iters=iters)
    close(got, want, 2e-5)
    if iters == 100:
        p, R = ta.fk(got)
        close(p, DOWN[:3], 1e-4)
        assert float(R[2, 2]) < -0.999


# poses on both sides of roll = pi (the tray's roll box is (2.39, 3.89)),
# a yaw near the wrist's +-pi wrap, and a pitched, rolled one
INIT_POSES = [DOWN, [0.45, 0.05, 0.3, np.pi - 0.3, 0.0, 0.2],
              [0.5, -0.05, 0.35, np.pi + 0.3, 0.1, -0.4],
              [0.45, 0.0, 0.3, np.pi, 0.0, 3.1], [0.4, 0.1, 0.25, 2.6, -0.4, 1.5]]


@pytest.mark.parametrize("pose", INIT_POSES)
def test_init_matches_jax_in_the_tray_convention(pose):
    je, te = envs()
    js = je.init(jnp.asarray(pose, jnp.float32))
    ts = te.init(np.asarray(pose, np.float32))
    close(ts.q, js.q, 2e-5, "q")
    close(ts.pose, js.pose, 2e-5, "pose")
    assert 2.39 < float(ts.pose[3]) < 3.89 and ts.count == 0


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_30_velocity_steps_match_jax(backend):
    """Random twists and a push into the scene's first object: joints,
    joint rates, pose, twist and objects after every step; the drift
    correction (every 20 commands) lands at step 20 on both sides."""
    je, te = envs(**BACKENDS[backend])
    start = [0.42, -0.06, 0.26, np.pi, 0.0, 0.0]  # low over the first object
    js = je.init(jnp.asarray(start, jnp.float32))
    ts = arm_state_from_jax(js, "cpu")
    step = jax.jit(je.step_vel)
    rng = np.random.default_rng(1)
    cmds = [[0, 0, -0.3, 0, 0, 0]] * 4 + list(rng.uniform(-0.15, 0.15, (26, 6)))
    for k, c in enumerate(cmds):
        c = np.asarray(c, np.float32)
        js = step(js, jnp.asarray(c))
        ts = te.step_vel(ts, T(c))
        for name in ("q", "qdot", "pose", "vel"):
            close(getattr(ts, name), getattr(js, name), 2e-5, f"step {k} {name}")
        close(ts.scene.obj_xy, js.scene.obj_xy, 1e-6, f"step {k} objects")
        assert ts.count == int(js.count) == k + 1


def test_drift_correction_relevels_at_step_20():
    """With a roll twist, the 20th command re-levels roll and pitch; the
    19th does not."""
    je, te = envs(fix_z=True)
    js = je.init(jnp.asarray(DOWN, jnp.float32))
    ts = arm_state_from_jax(js, "cpu")
    step = jax.jit(je.step_vel)
    cmd = np.array([0.02, 0.0, 0.0, 0.3, 0.0, 0.0], np.float32)
    rolls = []
    for _ in range(20):
        js = step(js, jnp.asarray(cmd))
        ts = te.step_vel(ts, T(cmd))
        rolls.append(abs(float(ts.pose[3]) - np.pi))
    close(ts.pose, js.pose, 2e-5)
    assert rolls[-1] < 0.2 * rolls[-2]


def test_step_pose_matches_jax():
    je, te = envs()
    js = je.init(jnp.asarray(DOWN, jnp.float32))
    ts = arm_state_from_jax(js, "cpu")
    step = jax.jit(je.step_pose)
    target = np.array([0.5, 0.1, 0.35, np.pi, 0.0, 0.5], np.float32)
    for k in range(12):
        js = step(js, jnp.asarray(target))
        ts = te.step_pose(ts, T(target))
        for name in ("q", "qdot", "pose", "vel"):
            close(getattr(ts, name), getattr(js, name), 5e-5, f"step {k} {name}")
    js = je.step_pose(js, jnp.asarray(target), 0.4)
    ts = te.step_pose(ts, T(target), T(0.4))
    assert float(ts.brightness) == pytest.approx(0.4)


def test_reset_joints_matches_jax():
    je, te = envs()
    js = je.step_vel(je.init(jnp.asarray(DOWN, jnp.float32)), jnp.asarray([0.1, 0.1, 0, 0, 0, 0.]))
    ts = te.reset_joints(arm_state_from_jax(js, "cpu"))
    js = je.reset_joints(js)
    close(ts.q, js.q, 0)
    close(ts.pose, js.pose, 1e-5)
    close(ts.vel, js.vel, 0)


CONTACT_POSES = [[0.45 + 0.06, 0.0, 0.25, np.pi, 0, 0],  # side, shallow
                 [0.45 + 0.03, 0.0, 0.25, np.pi, 0, 0],  # side, deep
                 [0.45, 0.02, 0.44, np.pi, 0, 0],  # pressing the top
                 [0.45, 0.0, 0.15, np.pi, 0, 0],  # below the table too
                 [0.7, -0.3, 0.45, np.pi, 0, 0]]  # free space


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("pose", CONTACT_POSES)
def test_contact_force_and_wrench_match_jax(backend, pose):
    je, te = envs(**BACKENDS[backend])
    js_, ts_ = big_cylinder()
    for scenes in ((js_, ts_), (JScene.default(), TrayScene.default("cpu"))):
        close(te._contact_force(T(pose), scenes[1]),
              je._contact_force(jnp.asarray(pose, jnp.float32), scenes[0]), 1e-5, "force")
        f, push = je._contact_wrench(jnp.asarray(pose, jnp.float32), scenes[0])
        ft, pt = te._contact_wrench(T(pose), scenes[1])
        close(ft, f, 1e-5, "wrench")
        close(pt, push, 1e-6, "push")


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_observe_matches_jax(backend):
    """Pose, twist, force (the wrench (3,) with dynamic contact, else (1,))
    and the 24x24 image, over the first object."""
    je, te = envs(img_hw=(24, 24), **BACKENDS[backend])
    js = je.init(jnp.asarray([0.42, -0.06, 0.21, np.pi, 0, 0], jnp.float32))
    js = je.step_vel(js, jnp.asarray([0.0, 0.0, -0.2, 0, 0, 0.3], jnp.float32))
    ts = arm_state_from_jax(js, "cpu")
    for got, want, tol in zip(te.observe(ts), je.observe(js), (0, 0, 1e-5, 2e-5)):
        assert tuple(got.shape) == want.shape
        close(got, want, tol)
    nf = 3 if BACKENDS[backend].get("dynamic_contact") else 1
    assert te.observe(ts)[2].shape == (nf,)


def test_mechanical_wedge_blocks_then_escapes():
    """Deep side contact (25 N > 0.75 x 30 N) blocks motion into the
    cylinder on both sides; the stuck detector's escape along +force frees
    the end effector (tests/test_arm.py's wedge)."""
    je, te = envs(dynamic_contact=True)
    jsc, tsc = big_cylinder()
    start = jnp.asarray([0.45 + 0.03, 0.0, 0.25, np.pi, 0.0, 0.0], jnp.float32)
    js = je.init(start, scene=jsc)
    ts = arm_state_from_jax(js, "cpu")
    step = jax.jit(je.step_vel)
    into = np.array([-0.05, 0, 0, 0, 0, 0], np.float32)
    poses = []
    for _ in range(2):
        js = step(js, jnp.asarray(into))
        ts = te.step_vel(ts, T(into))
        poses.append(ts.pose.numpy().copy())
        close(ts.pose, js.pose, 2e-5)
    force = te.observe(ts)[2].numpy()
    assert np.linalg.norm(force) > 0.75 * te.max_force
    assert np.linalg.norm(poses[1] - poses[0]) < 1e-5
    det = StuckDetector()
    det.check(poses[0], force=force)
    ok, escape = det.check(poses[1], force=force)
    assert not ok and escape[0] > 0
    esc6 = np.zeros(6, np.float32)
    esc6[:3] = escape
    for _ in range(30):
        js = step(js, jnp.asarray(esc6))
        ts = te.step_vel(ts, T(esc6))
    close(ts.pose, js.pose, 1e-4)
    assert np.linalg.norm(te.observe(ts)[2].numpy()) < 0.2 * np.linalg.norm(force)


def test_soft_objects_never_block():
    je, te = envs(dynamic_contact=True, soft_objects=True)
    jsc, tsc = big_cylinder()
    js = je.init(jnp.asarray([0.48, 0.0, 0.25, np.pi, 0, 0], jnp.float32), scene=jsc)
    ts = arm_state_from_jax(js, "cpu")
    x0 = float(ts.pose[0])
    for _ in range(5):
        js = je.step_vel(js, jnp.asarray([-0.05, 0, 0, 0, 0, 0], jnp.float32))
        ts = te.step_vel(ts, T([-0.05, 0, 0, 0, 0, 0]))
    close(ts.pose, js.pose, 2e-5)
    assert float(ts.pose[0]) < x0 - 1e-3


def test_pose_rate_wraps_the_euler_jump():
    """A yaw step across +-pi reads as a small rate on both sides."""
    je, te = envs()
    prev = np.array([0.45, 0, 0.3, np.pi, 0.0, np.pi - 0.01], np.float32)
    pose = np.array([0.45, 0, 0.3, -np.pi + 0.02, 0.0, -np.pi + 0.01], np.float32)
    want = je._pose_rate(jnp.asarray(pose), jnp.asarray(prev))
    got = te._pose_rate(T(pose), T(prev))
    close(got, want, 1e-4)
    assert abs(float(got[5])) < 1.0


def test_arm_state_from_jax_round_trips():
    je, _ = envs()
    js = je.init(jnp.asarray(DOWN, jnp.float32))
    js = js._replace(count=jnp.asarray(7, jnp.int32))
    ts = arm_state_from_jax(js, "cpu")
    assert ts.count == 7 and ts.q.dtype == torch.float32
    close(ts.scene.obj_color, js.scene.obj_color, 0)

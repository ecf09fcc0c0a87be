"""The port's renderer and synthetic env against the JAX package, at fixed
poses (f32; the two sides differ only in rounding of the pixel grid and
the transcendental functions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.sim import TrayScene as JScene, SyntheticEnv as JEnv, render_camera as j_render
from ealv_tpu.utils.config import TRAY_LIM
from ealv_tpu_torch.sim import TrayScene, SyntheticEnv, render_camera
from test_torch_trainer import one_torch_thread  # noqa: F401

TRAY6 = tuple(TRAY_LIM[s] for s in "xyzrpw")
POSES = [
    [0.45, 0.0, 0.3, 0.0, 0.0, 0.0],
    [0.42, -0.06, 0.21, 0.1, -0.2, 0.7],  # low over the first object
    [0.53, 0.07, 0.5, -0.3, 0.25, -1.9],
    [0.6, 0.12, 0.01, 0.0, 0.0, 2.0],  # below the camera's z floor
]


@pytest.mark.parametrize("pose", POSES)
@pytest.mark.parametrize("hw,brightness", [((24, 24), 1.0), ((40, 31), 0.6)])
def test_render_camera_matches_jax(pose, hw, brightness):
    want = j_render(JScene.default(), jnp.array(pose), brightness, hw)
    got = render_camera(TrayScene.default("cpu"), torch.tensor(pose), brightness, hw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)


def test_render_full_size_matches_jax():
    pose = POSES[1]
    want = j_render(JScene.default(), jnp.array(pose), 1.0, (180, 180))
    got = render_camera(TrayScene.default("cpu"), torch.tensor(pose), 1.0, (180, 180))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("pose", POSES + [[0.42, -0.06, 0.2, 0, 0, 0],
                                          [0.53, 0.07, 0.2, 0, 0, 0]])
def test_contact_force_matches_jax(pose):
    je = JEnv(tray_lim=TRAY6, img_hw=(16, 16))
    te = SyntheticEnv(tray_lim=TRAY6, img_hw=(16, 16), device="cpu")
    want = je._contact_force(jnp.array(pose), JScene.default())
    got = te._contact_force(torch.tensor(pose), TrayScene.default("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_step_vel_and_observe_match_jax():
    """A command sequence that drives into an object (force block), into
    the box limits, and back: poses, velocities, forces and images."""
    je = JEnv(tray_lim=TRAY6, dt=0.04, img_hw=(20, 20))
    te = SyntheticEnv(tray_lim=TRAY6, dt=0.04, img_hw=(20, 20), device="cpu")
    start = [0.42, -0.06, 0.3, 3.14, 0.0, 0.0]
    js = je.init(jnp.array(start))
    ts = te.init(torch.tensor(start))
    rng = np.random.default_rng(0)
    cmds = [[0, 0, -2.0, 0, 0, 0]] * 6 + [[3.0, 3.0, 0, 0.5, -0.5, 1]] * 6 \
        + list(rng.uniform(-1, 1, (8, 6)))
    for c in cmds:
        c = np.asarray(c, np.float32)
        js = je.step_vel(js, jnp.array(c))
        ts = te.step_vel(ts, torch.from_numpy(c))
        jo, to = je.observe(js), te.observe(ts)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    assert float(ts.pose[2]) >= TRAY_LIM["z"][0]


@pytest.mark.parametrize("k,seed", [(1, 0), (3, 5), (6, 2)])
def test_scene_make_matches_jax(k, seed):
    """The K-object scene from the same numpy seed, and its rendering."""
    js, ts = JScene.make(k, seed), TrayScene.make(k, seed, device="cpu")
    for name in ("obj_xy", "obj_radius", "obj_height", "obj_color", "ground_color"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    pose = [0.47, 0.01, 0.3, 0.0, 0.0, 0.3]
    np.testing.assert_allclose(render_camera(ts, torch.tensor(pose), 1.0, (20, 20)).numpy(),
                               np.asarray(j_render(js, jnp.array(pose), 1.0, (20, 20))),
                               rtol=1e-5, atol=1e-5)


def test_move_objects_matches_jax_with_fed_draw():
    """The JAX placement's unit draw, fed, gives its object centres; the
    port's own draw lands inside the limits."""
    import jax
    lims = np.asarray([TRAY_LIM["x"], TRAY_LIM["y"]], np.float32)
    js, ts = JScene.make(4, 1), TrayScene.make(4, 1, device="cpu")
    key = jax.random.PRNGKey(3)
    want = js.move_objects(key, jnp.asarray(lims)).obj_xy
    unit = torch.tensor(np.asarray(jax.random.uniform(key, (4, 2))))
    got = ts.move_objects(torch.from_numpy(lims), xy=unit).obj_xy
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    own = ts.move_objects(torch.from_numpy(lims), generator=torch.Generator().manual_seed(0))
    assert torch.all(own.obj_xy >= torch.from_numpy(lims[:, 0]))
    assert torch.all(own.obj_xy <= torch.from_numpy(lims[:, 1]))
    assert torch.equal(own.obj_color, ts.obj_color)


def test_step_pose_matches_jax():
    """Pose commands inside and outside the box, with and without a
    brightness command: pose, velocity, brightness and the image."""
    je = JEnv(tray_lim=TRAY6, dt=0.04, img_hw=(20, 20))
    te = SyntheticEnv(tray_lim=TRAY6, dt=0.04, img_hw=(20, 20), device="cpu")
    start = [0.45, 0.0, 0.3, 3.14, 0.0, 0.0]
    js, ts = je.init(jnp.array(start)), te.init(torch.tensor(start))
    targets = [[0.5, 0.05, 0.25, 3.0, 0.1, 0.4], [0.9, -0.5, 0.0, 5.0, 1.0, -3.0]]
    for i in range(6):
        c = np.asarray(targets[i % 2], np.float32)
        b = 0.4 if i == 3 else None
        js = je.step_pose(js, jnp.array(c), None if b is None else jnp.float32(b))
        ts = te.step_pose(ts, torch.from_numpy(c), None if b is None else torch.tensor(b))
        for a, w in zip(te.observe(ts), je.observe(js)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(ts.brightness.numpy(), np.asarray(js.brightness))
    assert float(ts.brightness) == pytest.approx(0.4)

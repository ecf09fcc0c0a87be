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

"""The port's numpy-only config and state helpers against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.utils import config as jcfg
from ealv_tpu.utils.states import ws_conversion as jax_ws
from ealv_tpu.models.cvae import conv_output_dims as jax_conv_dims
from ealv_tpu_torch.utils import config as tcfg
from ealv_tpu_torch.utils import states as tstates


def _fields(c):
    d = dataclasses.asdict(c)
    return d, {
        "tray_lim": c.tray_lim, "tray_ctrl_lim": c.tray_ctrl_lim,
        "robot_lim": c.robot_lim, "robot_ctrl_lim": c.robot_ctrl_lim,
        "std": c.std, "s_dim": c.s_dim, "sel": c.sel(),
        "model_hidden": c.model_hidden(),
    }


def _assert_same(a, b):
    fa, da = _fields(a)
    fb, db = _fields(b)
    assert fa == fb
    for k in da:
        np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]), err_msg=k)


@pytest.mark.parametrize("kwargs", [
    {},
    dict(states="xyw", num_target_samples=64, num_traj_samples=100,
         image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2),
    # a feature dim large enough for the auto-added FC layer
    dict(states="xyz", image_dim=(300, 300, 3), hidden_dim=(64, 32)),
])
def test_same_kwargs_give_same_fields(kwargs):
    _assert_same(jcfg.ExperimentConfig(**kwargs), tcfg.ExperimentConfig(**kwargs))


def test_same_yaml_gives_same_fields(tmp_path):
    path = tmp_path / "cfg.yaml"
    jcfg.ExperimentConfig(states="xyzw", z_dim=8, hidden_dim=(128, 64),
                          compute_dtype="float32").to_yaml(str(path))
    _assert_same(jcfg.ExperimentConfig.from_yaml(str(path), batch_size=16),
                 tcfg.ExperimentConfig.from_yaml(str(path), batch_size=16))


def test_tables_and_helpers_equal():
    for name in ("TRAY_LIM", "TRAY_CTRL_LIM", "ROBOT_LIM", "ROBOT_CTRL_LIM", "RAW_STATES"):
        assert getattr(jcfg, name) == getattr(tcfg, name)
    lim = np.array([[-1, 1], [-0.5, 2], [0, 3]], np.float32)
    assert jcfg.kernel_std(lim, 2000) == tcfg.kernel_std(lim, 2000)
    assert jcfg.expand_hidden((512, 256), 80000) == tcfg.expand_hidden((512, 256), 80000)
    for hw in [(180, 180), (36, 28), (24, 24)]:
        assert jax_conv_dims(hw, (3, 3, 5), (2, 2, 3)) == \
            tcfg.conv_output_dims(hw, (3, 3, 5), (2, 2, 3))


def test_ws_conversion_matches_jax():
    rng = np.random.default_rng(0)
    c = jcfg.ExperimentConfig(states="xyw")
    pts = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    want = jax_ws(jnp.array(pts), c.robot_lim, c.tray_lim)
    got = tstates.ws_conversion(torch.from_numpy(pts), torch.from_numpy(c.robot_lim),
                                torch.from_numpy(c.tray_lim))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # one point, extra trailing dims dropped
    p = rng.uniform(-1, 1, 5).astype(np.float32)
    want = jax_ws(jnp.array(p), c.robot_lim, c.tray_lim)
    got = tstates.ws_conversion(torch.from_numpy(p), torch.from_numpy(c.robot_lim),
                                torch.from_numpy(c.tray_lim))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_state_string_helpers_match():
    from ealv_tpu.utils import states as jstates
    for s in ("xyw", "xyXY", "xyzrpw"):
        assert jstates.find_non_vel_locs(s) == tstates.find_non_vel_locs(s)
        assert jstates.expand_states_double_integrator(s) == \
            tstates.expand_states_double_integrator(s)
        assert jstates.state_indices("xyzrpwb", s) == tstates.state_indices("xyzrpwb", s)
        assert [jstates.is_vel_state(ch) for ch in s] == [tstates.is_vel_state(ch) for ch in s]

"""The port's SO(3) utilities against ``ealv_tpu/utils/rotations.py``, at
angles near the roll wrap (0 and 2pi) and near pitch pi/2, with batch
dimensions. float32 on both sides; tolerances rtol 1e-5 / atol 1e-6 unless
a case says otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.utils import rotations as jrot
from ealv_tpu_torch.utils import rotations as trot
from test_torch_trainer import one_torch_thread  # noqa: F401

T = torch.from_numpy
TOL = dict(rtol=1e-5, atol=1e-6)
KINDS = ["generic", "roll_near_zero", "roll_near_2pi", "pitch_near_half_pi"]


def _angles(kind, shape=(4, 5)):
    rng = np.random.default_rng(KINDS.index(kind))
    a = rng.uniform(-0.7, 0.7, (*shape, 3))
    if kind == "roll_near_zero":
        a[..., 0] = rng.uniform(-1e-3, 1e-3, shape)
    elif kind == "roll_near_2pi":
        a[..., 0] = 2 * np.pi + rng.uniform(-1e-3, 1e-3, shape)
    elif kind == "pitch_near_half_pi":
        a[..., 1] = np.pi / 2 + rng.uniform(-2e-2, 2e-2, shape)
    return a.astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("kind", KINDS)
def test_euler_to_matrix_matches_jax(kind):
    a = _angles(kind)
    R = trot.euler_angles_to_matrix(T(a))
    assert R.shape == (4, 5, 3, 3)
    _close(R, jrot.euler_angles_to_matrix(jnp.asarray(a)))
    eye = torch.eye(3).expand_as(R)
    _close(trot.mm(R.transpose(-1, -2), R), eye)


@pytest.mark.parametrize("kind", KINDS)
def test_matrix_to_euler_matches_jax_and_round_trips(kind):
    a = _angles(kind)
    R = jrot.euler_angles_to_matrix(jnp.asarray(a))
    got = trot.matrix_to_euler_angles(T(np.array(R)))
    want = jrot.matrix_to_euler_angles(R)
    # near pitch pi/2 asin's slope amplifies the f32 rounding of R[2, 0]
    tol = dict(rtol=1e-5, atol=2e-3) if kind == "pitch_near_half_pi" else TOL
    _close(got, want, **tol)
    # round trip through the matrix: the same rotation, whatever the wrap
    _close(trot.euler_angles_to_matrix(got), R, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_wrap_angles_matches_jax(kind):
    a = _angles(kind)
    a[..., 2] += np.float32(np.pi)  # yaw across the -pi/pi seam too
    got = trot.wrap_angles(T(a))
    _close(got, jrot.wrap_angles(jnp.asarray(a)), rtol=0, atol=1e-6)
    assert float(got[..., 0].min()) >= 0.0 and float(got[..., 0].max()) < 2 * np.pi
    assert float(got[..., 1:].abs().max()) <= np.pi + 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_euler_rate_jacobian_matches_jax(kind):
    a = _angles(kind)
    got = trot.euler_rate_jacobian(T(a))
    want = jrot.euler_rate_jacobian(jnp.asarray(a))
    # 1/cos(p) near pi/2 is ~50: relative error of the f32 cos carries over
    tol = dict(rtol=2e-4, atol=1e-5) if kind == "pitch_near_half_pi" else TOL
    _close(got, want, **tol)


@pytest.mark.parametrize("scale", [0.0, 1e-9, 1e-4, 0.3, 3.0])
def test_hat_unhat_and_so3_exp_match_jax(scale):
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(3, 2, 3)) * scale).astype(np.float32)
    W = trot.hat(T(w))
    _close(W, jrot.hat(jnp.asarray(w)), rtol=0, atol=0)
    _close(W, -W.transpose(-1, -2), rtol=0, atol=0)
    _close(trot.unhat(W), w, rtol=0, atol=0)
    E = trot.so3_exp(T(w))
    _close(E, jrot.so3_exp(jnp.asarray(w)))
    _close(trot.mm(E.transpose(-1, -2), E), torch.eye(3).expand_as(E))


def test_mm_is_float32_matmul():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 7, 3, 3)).astype(np.float32)
    _close(trot.mm(T(a), T(b)), np.matmul(a.astype(np.float64), b), rtol=1e-5, atol=1e-6)

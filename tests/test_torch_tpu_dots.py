"""``ealv_tpu_torch/scripts/tpu_dots.py``: the port's arm kinematics with
each float32 product rounded as one bfloat16 pass (a TPU's default dot
precision), held against the JAX package's own chain
(``ealv_tpu/sim/arm.py::_dh_transform``, its DH tables and flange) with
the same rounding applied to each product's operands; the products of
bfloat16 values are exact in float32, so the two agree to float32
summation order (1e-6). Also: the patch is scoped to its block, and a
CLI runs under it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.sim import arm as jarm
from ealv_tpu_torch.scripts import tpu_dots
from ealv_tpu_torch.sim import arm
from test_torch_trainer import one_torch_thread  # noqa: F401

HI = jax.lax.Precision.HIGHEST


def rnd(x):
    return jnp.asarray(x, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32)


def dot(a, b):
    return jnp.matmul(rnd(a), rnd(b), precision=HI)


def jax_rounded_chain(q):
    """The reference's fk / geometric_jacobian chain, each product's
    operands rounded to bfloat16: (frames, p_ee, R_ee)."""
    T, frames = jnp.eye(4), []
    for i in range(7):
        T = dot(T, jarm._dh_transform(jarm._DH_A[i], jarm._DH_D[i], jarm._DH_ALPHA[i], q[i]))
        frames.append(T)
    E = dot(T, jnp.diag(jnp.ones(4)).at[2, 3].set(jarm._FLANGE_D))
    return frames, E[:3, 3], E[:3, :3]


def jax_rounded_jacobian(q):
    frames, p_ee, _ = jax_rounded_chain(q)
    return jnp.stack([jnp.concatenate([jnp.cross(T[:3, 2], p_ee - T[:3, 3]), T[:3, 2]])
                      for T in frames], axis=1)


QS = np.random.default_rng(0).uniform(np.asarray(jarm.Q_MIN), np.asarray(jarm.Q_MAX),
                                      (4, 7)).astype(np.float32)


@pytest.mark.parametrize("i", range(len(QS)))
def test_kinematics_round_as_a_bfloat16_pass(i):
    q = QS[i]
    _, p_j, R_j = jax_rounded_chain(jnp.asarray(q))
    J_j = jax_rounded_jacobian(jnp.asarray(q))
    with tpu_dots.tpu_dots():
        p, R = arm.fk(torch.tensor(q))
        J = arm.geometric_jacobian(torch.tensor(q))
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_j), rtol=0, atol=2e-6)
    # the rounding is what moves the pose: float32 fk is far from it
    p32, _ = arm.fk(torch.tensor(q))
    np.testing.assert_allclose(p32.numpy(), np.asarray(jarm.fk(jnp.asarray(q))[0]), atol=1e-6)
    assert np.abs(p32.numpy() - np.asarray(p_j)).max() > 1e-4


def test_damped_solve_rounds_as_the_reference():
    """``_dls_pinv(J) @ cmd`` with every product a bfloat16 pass."""
    q, cmd = QS[0], np.array([0.05, -0.02, 0.01, 0.1, -0.2, 0.3], np.float32)
    J = jax_rounded_jacobian(jnp.asarray(q))
    inv = jnp.linalg.solve(dot(J, J.T) + 1e-4 * jnp.eye(6), jnp.eye(6))
    want = dot(dot(J.T, inv), jnp.asarray(cmd)[:, None])[:, 0]
    with tpu_dots.tpu_dots():
        got = arm._dls_solve(torch.tensor(np.asarray(J)), torch.tensor(cmd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_patch_is_scoped():
    saved = {name: getattr(arm, name) for name in tpu_dots.PATCHES}
    with tpu_dots.tpu_dots():
        assert all(getattr(arm, n) is f for n, f in tpu_dots.PATCHES.items())
    assert all(getattr(arm, n) is f for n, f in saved.items())


def test_cli_runs_under_the_patch(capsys):
    out = tpu_dots.main(["force_study", "--small", "--device", "cpu", "--steps", "2",
                         "--backend", "arm-dynamic", "--eval-samples", "2"])
    assert out["steps"] == 2
    assert "one bfloat16 pass" in capsys.readouterr().out
    assert arm._chain is not tpu_dots._chain

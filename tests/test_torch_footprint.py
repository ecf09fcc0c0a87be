"""K1 and the ergodic ops of the torch port against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. The JAX
Pallas kernel runs in interpret mode on the CPU, as tests/test_kernels.py
runs it. TF32 is off for every f32 comparison (it only exists on the card;
the flags are set so a run on the card compares the same thing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.ops import kernels as jk
from ealv_tpu.ops.pallas_kernels import footprint_and_spread as jax_k1
from ealv_tpu_torch.ops import footprint as tfp
from ealv_tpu_torch.ops import kernels as tk

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


def _inputs(n, t, d, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    samples = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    traj = rng.uniform(-1, 1, (t, d)).astype(np.float32)
    std = np.full(d, 0.05, np.float32)
    std[d // 2:] = 0.25
    if mask_kind == "random":
        mask = (rng.uniform(size=t) > 0.3).astype(np.float32)
    elif mask_kind == "zero":  # empty history ring
        mask = np.zeros(t, np.float32)
    else:
        mask = np.ones(t, np.float32)
    return samples, traj, std, mask


# non-tile-multiple sizes, d = 2/4/6, an empty history, the inner-loop shape
PROBES = [(700, 900, 4, "random"), (700, 900, 2, "random"),
          (700, 900, 6, "random"), (300, 500, 3, "zero"), (2000, 10, 3, "ones")]


@pytest.mark.parametrize("n,t,d,mask_kind", PROBES)
def test_plain_k1_matches_pallas_interpret(n, t, d, mask_kind):
    """Both whiten by rsqrt|std| and take direct differences in f32, so
    only the summation order differs: rtol 1e-5, atol 1e-6."""
    s, x, std, m = _inputs(n, t, d, mask_kind)
    want_sum, want_max = jax_k1(jnp.array(s), jnp.array(x), jnp.array(std),
                                jnp.array(m), interpret=True)
    got_sum, got_max = tfp.footprint_and_spread_reference(T(s), T(x), T(std), T(m))
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_max.numpy(), np.asarray(want_max), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,t,d,mask_kind", PROBES)
def test_traj_footprint_and_spread_match_jax(n, t, d, mask_kind):
    """The JAX side takes the |a|^2+|b|^2-2ab expansion on the CPU, whose
    cancellation exp() amplifies: rtol 1e-3, atol 1e-4 (as
    tests/test_kernels.py holds the two JAX forms)."""
    s, x, std, m = _inputs(n, t, d, mask_kind, seed=1)
    full = np.concatenate([x, x[:, ::-1]], 1)  # full-state rows, explore the first d
    idx = list(range(d))
    for fn_t, fn_j in ((tk.traj_footprint, jk.traj_footprint),
                       (tk.traj_spread, jk.traj_spread)):
        want = fn_j(jnp.array(full), jnp.array(s), jnp.array(idx), jnp.array(std),
                    nu=2.0, traj_mask=jnp.array(m))
        got = fn_t(T(full), T(s), idx, T(std), nu=2.0, traj_mask=T(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_footprint_without_mask_counts_every_row():
    s, x, std, _ = _inputs(50, 40, 3, "ones", seed=2)
    want = jk.traj_footprint(jnp.array(x), jnp.array(s), jnp.arange(3), jnp.array(std))
    got = tk.traj_footprint(T(x), T(s), [0, 1, 2], T(std))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_cpu_calls_never_count_as_kernel_launches():
    before = tfp.footprint_and_spread.launches
    s, x, std, m = _inputs(20, 30, 3, "random")
    tk.traj_spread(T(x), T(s), [0, 1, 2], T(std), traj_mask=T(m))
    tfp.footprint_and_spread(T(s), T(x), T(std), T(m))
    assert tfp.footprint_and_spread.launches == before


def test_other_devices_raise():
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(TypeError):
        tfp.footprint_and_spread(meta, meta, torch.empty(3, device="meta"),
                                 torch.empty(4, device="meta"))


def test_psi_matrix_matches_jax():
    s, x, std, m = _inputs(60, 45, 3, "random", seed=3)
    want = jk.psi_matrix(jnp.array(s), jnp.array(x), jnp.array(std), jnp.array(m))
    got = tk.psi_matrix(T(s), T(x), T(std), T(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)


def test_kldiv_grad_batch_matches_jax():
    rng = np.random.default_rng(4)
    xs = rng.uniform(-1, 1, (10, 6)).astype(np.float32)
    samples = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    std = np.array([0.05, 0.05, 0.25], np.float32)
    ratio = rng.uniform(0.5, 2.0, 200).astype(np.float32)
    want = jk.kldiv_grad_batch(jnp.array(xs), jnp.array(samples), jnp.arange(3),
                               jnp.array(std), jnp.array(ratio), nu=1.5)
    got = tk.kldiv_grad_batch(T(xs), T(samples), [0, 1, 2], T(std), T(ratio), nu=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("axis", [None, 1])
def test_renormalize_matches_jax(axis):
    rng = np.random.default_rng(5)
    d = rng.uniform(0, 1, (4, 50)).astype(np.float32)
    d[0, :10] = 0.0  # clamped entries
    want = jk.renormalize(jnp.array(d), axis=axis)
    got = tk.renormalize(T(d), dim=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_cost_norm_matches_jax():
    d = np.random.default_rng(6).uniform(0, 1, 30).astype(np.float32)
    d[3] = np.nan
    want = jk.cost_norm(jnp.array(d))
    got = tk.cost_norm(T(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

"""K1 and the ergodic ops of the torch port against the JAX package.

Inputs are made with numpy from a seed and fed to both sides. The JAX
Pallas kernel runs in interpret mode on the CPU, as tests/test_kernels.py
runs it. TF32 is off for every f32 comparison (it only exists on the card;
the flags are set so a run on the card compares the same thing). Torch
runs on one thread, as in the port's other test files: the plain version's
(700, 900) reductions then run in the test's own thread, never split over
a pool that shares the machine with the other test workers.
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
from test_torch_trainer import one_torch_thread  # noqa: F401

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


# ---- the kernel's schedule (csrc/footprint.cu), emulated on the CPU ----

# the probes, the main path's two shapes, and T-splits cut unevenly: a T
# that S does not divide, more splits than points per split, splits longer
# than one staged stretch, T = 1, d = 8
PLAN_SHAPES = [(n, t, d) for n, t, d, _ in PROBES] + [
    (2000, 3000, 3), (2000, 3001, 3), (3, 6400, 2), (33, 80000, 5), (1500, 700, 8),
    (1, 1, 3), (2000, 1, 3), (129, 513, 7)]
STAGE = 256  # kStage in csrc/footprint.cu


def _split_ranges(plan):
    return [(k * plan.split_len, min((k + 1) * plan.split_len, plan.t))
            for k in range(plan.splits)]


@pytest.mark.parametrize("n,t,d", PLAN_SHAPES)
def test_plan_covers_every_point_and_row_once(n, t, d):
    """Every trajectory point lies in exactly one non-empty split, every row
    below n is owned by exactly one (tile, thread, r) and rows past n are
    never written; the grid reaches MIN_BLOCKS unless splits would fall
    under MIN_SPLIT points."""
    plan = tfp.footprint_plan(n, t, d)
    seen = np.zeros(t, np.int64)
    for lo, hi in _split_ranges(plan):
        assert lo < hi
        seen[lo:hi] += 1
        # the kernel stages [lo, hi) in stretches of STAGE points
        staged = sum(min(STAGE, hi - b) for b in range(lo, hi, STAGE))
        assert staged == hi - lo
    assert (seen == 1).all()
    per_tile = tfp.THREADS * tfp.ROWS
    written = np.zeros(plan.tiles * per_tile, np.int64)
    for tile in range(plan.tiles):
        for r in range(tfp.ROWS):
            rows = tile * per_tile + r * tfp.THREADS + np.arange(tfp.THREADS)
            written[rows] += 1
    assert (written == 1).all() and written.size >= n
    assert written.size - n < per_tile  # only the last tile is ragged
    blocks = plan.splits * plan.tiles
    assert blocks >= tfp.MIN_BLOCKS or plan.splits == max(1, t // tfp.MIN_SPLIT)
    assert plan.ws_elems == (2 * plan.splits * n if plan.splits > 1 else 0)


@pytest.mark.parametrize("n,t,d", PLAN_SHAPES)
def test_split_schedule_matches_plain(n, t, d):
    """The plan's schedule in torch: each split's partial (sum, max) from
    the plain version over its slice of T, then summed and maxed in split
    order as the second kernel does. Against the plain version over all of
    T: summation order only, rtol 1e-5, atol 1e-6."""
    s, x, std, m = _inputs(n, t, d, "random", seed=7)
    s, x, std, m = T(s), T(x), T(std), T(m)
    plan = tfp.footprint_plan(n, t, d)
    acc_sum = torch.zeros(n)
    acc_max = torch.full((n,), -torch.inf)
    for lo, hi in _split_ranges(plan):
        part_sum, part_max = tfp.footprint_and_spread_reference(s, x[lo:hi], std, m[lo:hi])
        acc_sum = acc_sum + part_sum
        acc_max = torch.where((part_max > acc_max) | part_max.isnan(), part_max, acc_max)
    want_sum, want_max = tfp.footprint_and_spread_reference(s, x, std, m)
    torch.testing.assert_close(acc_sum, want_sum, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(acc_max, want_max, rtol=1e-5, atol=1e-6)


def test_split_schedule_propagates_nan():
    """A NaN in one split's points reaches the row's max through the
    ordered combine, as torch.amax propagates it."""
    s, x, std, m = (T(a) for a in _inputs(5, 300, 3, "ones"))
    x[250, 1] = float("nan")
    plan = tfp.footprint_plan(5, 300, 3)
    assert plan.splits > 1
    _, want_max = tfp.footprint_and_spread_reference(s, x, std, m)
    acc = torch.full((5,), -torch.inf)
    for lo, hi in _split_ranges(plan):
        _, part = tfp.footprint_and_spread_reference(s, x[lo:hi], std, m[lo:hi])
        acc = torch.where((part > acc) | part.isnan(), part, acc)
    assert want_max.isnan().all() and acc.isnan().all()


def test_main_path_plans():
    """The planner's two shapes: 2000x3000 splits T to fill the card, the
    launch-bound 2000x10 takes one pass and no workspace."""
    big, small = tfp.footprint_plan(2000, 3000, 3), tfp.footprint_plan(2000, 10, 3)
    assert big.splits > 1 and big.splits * big.tiles >= 132
    assert big.split_len >= tfp.MIN_SPLIT
    assert small.splits == 1 and small.ws_elems == 0
    assert tfp.footprint_plan(2000, 3000, 3) is big  # cached per shape

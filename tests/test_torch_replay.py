"""The port's replay and trajectory rings against the JAX package.

Ring contents and sampling weights are compared exactly; the sampling law
(Gumbel top-k from a torch.Generator, whose bits differ from JAX's) is
checked statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.data.replay import ReplayBuffer as JRB, TrajMemory as JTM
from ealv_tpu_torch.data.replay import ReplayBuffer, TrajMemory

IMG = (4, 5, 3)


def _pair(cap, n_push, seed=0, img_dtype="float32"):
    rng = np.random.default_rng(seed)
    jb = JRB.create(cap, 3, IMG, beta_capacity=4, img_dtype=jnp.dtype(img_dtype))
    tb = ReplayBuffer.create(cap, 3, IMG, "cpu", beta_capacity=4,
                             img_dtype=getattr(torch, img_dtype))
    for _ in range(n_push):
        x = rng.uniform(-1, 1, 3).astype(np.float32)
        y = rng.uniform(0, 1, IMG).astype(np.float32)
        f = rng.uniform(0, 5, 1).astype(np.float32)
        jb = jb.push(jnp.array(x), jnp.array(y), jnp.array(f))
        tb.push(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(f))
    return jb, tb


@pytest.mark.parametrize("cap,n_push", [(6, 0), (6, 4), (6, 6), (6, 11), (7, 23)])
def test_push_and_wrap_match_jax(cap, n_push):
    jb, tb = _pair(cap, n_push)
    for name in ("x", "y", "force"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(tb.y_var.numpy(), np.asarray(jb.y_var), rtol=1e-6)
    assert (tb.pos, tb.size, tb.total) == (int(jb.pos), int(jb.size), int(jb.total))
    x, mask = tb.get_all_x()
    jx, jmask = jb.get_all_x()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_bf16_image_ring():
    jb, tb = _pair(5, 7, img_dtype="bfloat16")
    assert tb.y.dtype == torch.bfloat16 and tb.x.dtype == torch.float32
    np.testing.assert_array_equal(tb.y.float().numpy(), np.asarray(jb.y, np.float32))
    # the variance is of the f32 image, before the ring's rounding
    np.testing.assert_allclose(tb.y_var.numpy(), np.asarray(jb.y_var), rtol=1e-6)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("cap,n_push", [(8, 1), (8, 5), (8, 8), (8, 13), (9, 30)])
def test_sampling_weights_equal_jax(cap, n_push, weighted):
    """The weights are multiples of 1/2, so JAX's are recovered exactly
    from its log weights and compared for equality; the logs themselves
    may differ in the last bit (XLA's and torch's log), so they are held
    to rtol 2e-7."""
    jb, tb = _pair(cap, n_push, seed=1)
    want_log = np.asarray(jb._weights_log(weighted))
    valid = want_log > -1e29
    want = np.where(valid, np.round(2 * np.exp(np.where(valid, want_log, 0))) / 2, 0)
    np.testing.assert_array_equal(tb._weights(weighted).numpy(), want.astype(np.float32))
    got_log = tb._weights_log(weighted).numpy()
    np.testing.assert_array_equal(got_log > -1e29, valid)
    np.testing.assert_allclose(got_log[valid], want_log[valid], rtol=2e-7, atol=0)


def test_update_hyperparams_nan_guard_matches_jax():
    jb, tb = _pair(4, 2)
    pushes = [(0, 0.1, 0.2), (1, np.nan, 0.3), (2, 0.4, np.inf), (3, 0.5, 0.6),
              (4, 0.7, 0.8), (5, 0.9, 1.0), (6, 1.1, 1.2)]
    for ind, g, s in pushes:
        jb = jb.update_hyperparams(ind, jnp.float32(g), jnp.float32(s))
        tb.update_hyperparams(ind, torch.tensor(g, dtype=torch.float32),
                              torch.tensor(s, dtype=torch.float32))
        for name in ("beta", "gamma", "beta_pos", "beta_size", "explr_ind"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)), err_msg=name)


@pytest.mark.parametrize("weighted", [True, False])
def test_sampling_law(weighted):
    """The first draw of a Gumbel top-k picks slot i with probability
    w_i / sum(w): check 20000 draws against that law (5 sigma), and that
    every batch is valid and without replacement."""
    _, tb = _pair(10, 14, seed=2)  # wrapped ring
    g = torch.Generator().manual_seed(0)
    w = torch.exp(tb._weights_log(weighted)).numpy()
    p = w / w.sum()
    n = 20000
    first = np.zeros(10)
    for _ in range(n // 100):
        for _ in range(100):
            idx = tb.sample_indices(6, weighted=weighted, generator=g).numpy()
            assert len(set(idx)) == 6 and idx.max() < tb.size
            first[idx[0]] += 1
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(first - n * p) <= 5 * sigma + 1)


def test_batch_larger_than_fill_repeats_valid_draws():
    jb, tb = _pair(10, 3, seed=3)
    idx = tb.sample_indices(8, weighted=True, generator=torch.Generator().manual_seed(1))
    assert set(idx.tolist()) == {0, 1, 2}
    assert idx[:3].tolist() == idx[3:6].tolist()


def test_traj_memory_matches_jax():
    rng = np.random.default_rng(4)
    jm = JTM.create(5, 4)
    tm = TrajMemory.create(5, 4, "cpu")
    for i in range(8):
        s = rng.uniform(-1, 1, 4).astype(np.float32)
        skip = i == 3  # a nan measurement is not pushed
        if not skip:
            jm = jm.push(jnp.array(s))
        tm.push(torch.from_numpy(s), skip=torch.tensor(skip))
        np.testing.assert_array_equal(tm.buf.numpy(), np.asarray(jm.buf))
        assert int(tm.pos) == int(jm.pos) and int(tm.size) == int(jm.size)
        buf, mask = tm.get_all()
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm.get_all()[1]))


@pytest.mark.parametrize("n_push", [2, 9])
def test_traj_memory_sample_with_jax_draw(n_push):
    """Feeding the indices of the JAX draw gives the JAX sample."""
    rng = np.random.default_rng(5)
    jm = JTM.create(6, 2)
    tm = TrajMemory.create(6, 2, "cpu")
    for _ in range(n_push):
        s = rng.uniform(-1, 1, 2).astype(np.float32)
        jm = jm.push(jnp.array(s))
        tm.push(torch.from_numpy(s))
    key = jax.random.PRNGKey(7)
    want, want_mask = jm.sample(key, 4)
    # the JAX draw's indices: TrajMemory.sample's Gumbel top-k on this key
    logw = jnp.where(jnp.arange(6) < jm.size, 0.0, -1e30)
    idx = np.asarray(jax.lax.top_k(logw + jax.random.gumbel(key, (6,)), 4)[1])
    got, got_mask = tm.sample(4, idx=torch.tensor(idx, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    # the port's own draw: distinct, valid first
    idx = tm.sample_indices(4, generator=torch.Generator().manual_seed(0))
    assert len(set(idx.tolist())) == 4
    assert all(i < min(n_push, 6) for i in idx[: min(n_push, 4)].tolist())


@pytest.mark.parametrize("n_push,k", [(0, 3), (2, 4), (5, 3), (13, 5)])
def test_traj_memory_get_recent_matches_jax(n_push, k):
    """The last k pushed states, newest first, before and after the ring
    wraps, with the mask of the rows that were pushed."""
    rng = np.random.default_rng(6)
    jm = JTM.create(5, 3)
    tm = TrajMemory.create(5, 3, "cpu")
    for _ in range(n_push):
        s = rng.uniform(-1, 1, 3).astype(np.float32)
        jm = jm.push(jnp.array(s))
        tm.push(torch.from_numpy(s))
    (got, got_mask), (want, want_mask) = tm.get_recent(k), jm.get_recent(k)
    assert got.shape == (k, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))

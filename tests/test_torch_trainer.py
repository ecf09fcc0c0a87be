"""The port's trainer call against the JAX trainer, with fed draws.

The JAX ``train_call`` draws its batch indices and reparam noise from a
key; the test derives the same draws from that key with the JAX package's
own functions (``ReplayBuffer.sample_indices`` with ``train_call``'s key
splits; the noise recovered from a JAX forward as (z - z_mu) *
exp(-z_logvar / 2)) and feeds them to the port. Everything is f32, TF32 off.

Parameters after Adam steps: the first Adam step moves a parameter by
lr * g / (|g| + eps), so an element whose gradient is at rounding level
(|g| ~ eps) can move by up to lr with either sign. Gradients are compared
tightly; parameters are compared tightly where the JAX gradient is clear of
rounding (|g| > 1e-4 max|g| of its tensor) and within 2 * lr * steps
everywhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ealv_tpu.data.replay import ReplayBuffer as JRB
from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.losses import cvae_loss as j_loss
from ealv_tpu.runtime.trainer import TrainerStatics as JStatics, train_call as j_train
from ealv_tpu_torch.data.replay import ReplayBuffer
from ealv_tpu_torch.models import CVAE, cvae_loss
from ealv_tpu_torch.runtime.trainer import TrainerStatics, TrainDraws, train_call
from ealv_tpu_torch.utils.convert import params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

IMG, S, Z, HID, B, LR = (24, 24, 3), 3, 8, (64, 32), 8, 1e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tier-1 runs several test processes side by side on the machine's
    cores; torch's own thread pool in each of them would oversubscribe the
    cores, so a port test runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _train_draw_fn(jm, batch, weighted, bpp):
    @jax.jit
    def one(p, buf, k):
        k_b, k_b2, k_r = jax.random.split(k, 3)
        i1 = buf.sample_indices(k_b, batch, weighted=weighted)
        i2 = buf.sample_indices(k_b2, batch, weighted=False)
        s1, s2 = i1[:bpp], i2[:bpp]
        out = jm.apply(p, buf.x[s1], buf.y[s1], x_decode=buf.x[s2], train=True,
                       force=buf.force[s1] if jm.learn_force else None,
                       rngs={"reparam": k_r})
        return i1, i2, out["z"], out["z_mu"], out["z_logvar"]

    return one


def jax_train_draws(jm, jp, buf, key, steps, batch, weighted=True, num_shards=1):
    """The draws JAX ``train_call`` makes from ``key`` (other_locs on; the
    force variant's encoder reads the batch's forces): the global indices,
    and the reparam noise of one shard's batch / num_shards rows, which
    every shard draws alike from the replicated key."""
    one = _train_draw_fn(jm, batch, weighted, batch // num_shards)
    idx, idx2, eps = [], [], []
    for k in jax.random.split(key, steps):
        i1, i2, z, z_mu, z_logvar = map(np.asarray, one(jp, buf, k))
        idx.append(i1)
        idx2.append(i2)
        eps.append((z - z_mu) * np.exp(-0.5 * z_logvar))
    t = lambda a, dt: torch.tensor(np.stack(a), dtype=dt)
    return TrainDraws(idx=t(idx, torch.int64), idx2=t(idx2, torch.int64),
                      eps=t(eps, torch.float32))


@pytest.fixture(scope="module")
def setup():
    jm = JCVAE(img_dim=IMG, z_dim=Z, s_dim=S, hidden_dim=HID)
    jp = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, S)),
                                   jnp.zeros((1, *IMG)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    jb = JRB.create(16, S, IMG)
    tb = ReplayBuffer.create(16, S, IMG, "cpu")
    for _ in range(12):
        x = rng.uniform(-1, 1, S).astype(np.float32)
        y = rng.uniform(0, 1, IMG).astype(np.float32)
        jb = jb.push(jnp.array(x), jnp.array(y))
        tb.push(torch.from_numpy(x), torch.from_numpy(y))
    return jm, jp, jb, tb


def _port_model(jm, jp):
    tm = CVAE(img_dim=IMG, z_dim=Z, s_dim=S, hidden_dim=HID)
    tm.load_state_dict(params_from_jax(jp, tm))
    return tm


def _compare_params(tm, jp_new, jgrad, steps):
    want = params_from_jax(jp_new, tm)
    g = params_from_jax(jgrad, tm)
    for name, p in tm.named_parameters():
        got, w, gg = p.detach().numpy(), want[name].numpy(), np.abs(g[name].numpy())
        assert np.abs(got - w).max() <= 2 * LR * steps + 1e-6, name
        clear = gg > 1e-4 * gg.max()
        np.testing.assert_allclose(got[clear], w[clear], rtol=1e-4, atol=2e-6,
                                   err_msg=name)


def test_one_deterministic_step(setup):
    """Loss, metrics and gradients of one step (rtol 1e-4 / 1e-3), then the
    updated parameters."""
    jm, jp, jb, tb = setup
    key = jax.random.PRNGKey(5)
    draws = jax_train_draws(jm, jp, jb, key, 1, B)
    beta, gamma = 0.02, 0.4
    # the JAX gradient at this batch
    i1, i2 = jnp.asarray(draws.idx[0].numpy()), jnp.asarray(draws.idx2[0].numpy())

    def jloss(p):
        out = jm.apply(p, jb.x[i1], jb.y[i1], x_decode=jb.x[i2])
        return j_loss(out, jb.y[i1], y2=jb.y[i2], beta=beta, gamma=gamma,
                      gamma_weight=0.1, other_locs=True)[0]

    jgrad = jax.jit(jax.grad(jloss))(jp)
    statics_j = JStatics(model=jm, batch_size=B, num_learning_opt=1, lr=LR)
    jp1, _, jmet = jax.jit(lambda p, o: j_train(statics_j, p, o, jb, key, beta, gamma,
                                                deterministic=True))(
        jp, optax.adam(LR).init(jp))

    tm = _port_model(jm, jp)
    out = tm(tb.x[draws.idx[0]], tb.y[draws.idx[0]], x_decode=tb.x[draws.idx2[0]])
    loss, _ = cvae_loss(out, tb.y[draws.idx[0]], y2=tb.y[draws.idx2[0]], beta=beta,
                        gamma=gamma, other_locs=True)
    loss.backward()
    want_g = params_from_jax(jgrad, tm)
    for name, p in tm.named_parameters():
        g = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * np.abs(g).max() + 1e-8, err_msg=name)

    tm = _port_model(jm, jp)
    statics = TrainerStatics(batch_size=B, num_learning_opt=1, lr=LR)
    met = train_call(statics, tm, statics.make_optimizer(tm), tb,
                     torch.tensor(beta), torch.tensor(gamma), deterministic=True,
                     draws=draws)
    for k in ("loss", "rc", "kl", "rc_other", "z_activity"):
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("active_units", "active_units_vars"):
        np.testing.assert_array_equal(met[k].numpy(), np.asarray(jmet[k]))
    _compare_params(tm, jp1, jgrad, steps=1)


def test_two_step_call_with_fed_draws(setup):
    """A 2-step call with reparam noise: per-step loss and metrics at rtol
    1e-3 (the second step starts from parameters one Adam step apart by
    rounding), parameters as described above."""
    jm, jp, jb, tb = setup
    key = jax.random.PRNGKey(9)
    draws = jax_train_draws(jm, jp, jb, key, 2, B)
    beta, gamma = 0.01, 0.8
    statics_j = JStatics(model=jm, batch_size=B, num_learning_opt=2, lr=LR)
    jp2, _, jmet = jax.jit(lambda p, o: j_train(statics_j, p, o, jb, key, beta, gamma))(
        jp, optax.adam(LR).init(jp))

    tm = _port_model(jm, jp)
    statics = TrainerStatics(batch_size=B, num_learning_opt=2, lr=LR)
    met = train_call(statics, tm, statics.make_optimizer(tm), tb,
                     torch.tensor(beta), torch.tensor(gamma), draws=draws)
    for k in ("loss", "rc", "kl", "rc_other", "z_activity"):
        assert met[k].shape == (2,)
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    # gradient scale per tensor for the tolerance mask: the first step's
    # gradient, taken on the JAX side
    i1, i2 = jnp.asarray(draws.idx[0].numpy()), jnp.asarray(draws.idx2[0].numpy())

    def jloss(p):
        out = jm.apply(p, jb.x[i1], jb.y[i1], x_decode=jb.x[i2])
        return j_loss(out, jb.y[i1], y2=jb.y[i2], beta=beta, gamma=gamma,
                      gamma_weight=0.1, other_locs=True)[0]

    _compare_params(tm, jp2, jax.jit(jax.grad(jloss))(jp), steps=2)


def test_own_draws_run_and_learn(setup):
    """Without fed draws the call draws from its generator: finite
    metrics, a falling loss over repeated calls."""
    jm, jp, jb, tb = setup
    tm = _port_model(jm, jp)
    statics = TrainerStatics(batch_size=B, num_learning_opt=10, lr=LR)
    opt = statics.make_optimizer(tm)
    g = torch.Generator().manual_seed(0)
    first = train_call(statics, tm, opt, tb, torch.tensor(0.0), torch.tensor(0.5),
                       generator=g)
    for _ in range(3):
        last = train_call(statics, tm, opt, tb, torch.tensor(0.0), torch.tensor(0.5),
                          generator=g)
    assert all(torch.isfinite(v.float()).all() for v in last.values())
    assert float(last["loss"].mean()) < float(first["loss"].mean())


# ---- hyperparameter schedules (runtime/schedules.py) ----

from ealv_tpu.runtime import schedules as jsch  # noqa: E402
from ealv_tpu_torch.runtime import schedules as tsch  # noqa: E402


def test_entropy_grade_and_spread_match_jax():
    """f32 both sides; the JAX spread takes the footprint's expansion form
    on the CPU: rtol 1e-3."""
    rng = np.random.default_rng(1)
    pdf = rng.uniform(0.01, 2.0, 200).astype(np.float32)
    all_x = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    mask = (np.arange(50) < 31).astype(np.float32)
    samples = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    std = np.full(3, 0.05, np.float32)
    jg, js = jsch.entropy_grade_spread(jnp.array(pdf), jnp.array(all_x), jnp.array(mask),
                                       jnp.array(samples), jnp.arange(3), jnp.array(std))
    tg, ts = tsch.entropy_grade_spread(torch.from_numpy(pdf), torch.from_numpy(all_x),
                                       torch.from_numpy(mask), torch.from_numpy(samples),
                                       [0, 1, 2], torch.from_numpy(std))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-3)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-3)
    # an empty ring gives spread 0
    _, ts0 = tsch.entropy_grade_spread(torch.from_numpy(pdf), torch.from_numpy(all_x),
                                       torch.zeros(50), torch.from_numpy(samples),
                                       [0, 1, 2], torch.from_numpy(std))
    assert float(ts0) == 0.0
    for spread in (0.0, 0.3, 1.0):
        np.testing.assert_allclose(
            tsch.entropy_grade(torch.from_numpy(pdf), torch.tensor(spread)).numpy(),
            np.asarray(jsch.entropy_grade(jnp.array(pdf), jnp.float32(spread))), rtol=1e-5)


@pytest.mark.parametrize("flags", [
    {}, dict(fixed_beta=True, fixed_gamma=True, beta_start=0.02, gamma_start=0.3),
    dict(beta_manual_ramp=True, gamma_manual_ramp=True), dict(other_locs=False)])
def test_hyperparam_update_matches_jax(flags):
    jh = jsch.HyperState.create()._replace(iter=jnp.int32(275))
    th = tsch.HyperState.create("cpu")
    th.iter = 275
    jh = jsch.hyperparam_update(jh, jnp.float32(0.004), jnp.float32(0.6), **flags)
    th = tsch.hyperparam_update(th, torch.tensor(0.004), torch.tensor(0.6), **flags)
    np.testing.assert_allclose(th.beta.numpy(), np.asarray(jh.beta), rtol=1e-6)
    np.testing.assert_allclose(th.gamma.numpy(), np.asarray(jh.gamma), rtol=1e-6)

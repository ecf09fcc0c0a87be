"""The port's CVAE force variant (``learn_force``) and z-ensemble
(``use_z_ensemble``) against the JAX CVAE.

Both sides run from the same weights (JAX init -> ``params_from_jax``) on
inputs made with numpy from a seed, f32 with TF32 off: forward outputs and
losses at rtol 1e-4, gradients at rtol 1e-3, trainer metrics over two
steps at rtol 1e-3 (as ``test_torch_cvae.py`` and
``test_torch_trainer.py``); weight maps bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ealv_tpu.data.replay import ReplayBuffer as JRB
from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.cvae import init_model_state as j_init_state, update_dist as j_update
from ealv_tpu.models.losses import cvae_loss as j_loss
from ealv_tpu.runtime.trainer import TrainerStatics as JStatics, train_call as j_train
from ealv_tpu.utils.torch_import import convert_state_dict
from ealv_tpu_torch.data.replay import ReplayBuffer
from ealv_tpu_torch.models import CVAE, cvae_loss, init_model_state, update_dist
from ealv_tpu_torch.runtime.trainer import TrainerStatics, train_call
from ealv_tpu_torch.utils.convert import _feat_perm, opt_state_from_jax, params_from_jax
from test_torch_trainer import jax_train_draws, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

S_DIM, Z_DIM, HIDDEN, LR = 3, 8, (64, 32), 1e-3
IMG_DIMS = [(24, 24, 3), (36, 28, 3)]


def _models(img_dim, learn_force=True, seed=0):
    jm = JCVAE(img_dim=img_dim, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
               learn_force=learn_force)
    jp = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, S_DIM)),
                                   jnp.zeros((1, *img_dim)),
                                   force=jnp.zeros((1, 1)) if learn_force else None,
                                   train=False))(jax.random.PRNGKey(seed))
    # nonzero biases, so a misplaced bias row shows
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    tm = CVAE(img_dim=img_dim, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
              learn_force=learn_force)
    tm.load_state_dict(params_from_jax(jp, tm))
    return jm, jp, tm


def _data(img_dim, b=5, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    return (f32(rng.uniform(-1, 1, (b, S_DIM))), f32(rng.uniform(0, 1, (b, *img_dim))),
            f32(rng.uniform(0, 30, (b, 1))), f32(rng.uniform(-1, 1, (b, S_DIM))),
            f32(rng.uniform(0, 1, (b, *img_dim))), f32(rng.uniform(0, 30, (b, 1))))


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a.detach().float() if torch.is_tensor(a) else a),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol, err_msg=what)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("img_dim", IMG_DIMS)
def test_force_params_round_trip(img_dim):
    """JAX params -> port -> convert_state_dict -> the same JAX params, and
    a port init -> convert_state_dict -> params_from_jax -> the same
    state_dict, bit for bit: the force column and row stay in place."""
    jm, jp, tm = _models(img_dim)
    assert tm.encode[0].weight.shape[1] == tm.feat_dim + 1 + S_DIM
    assert tm.decode[4].weight.shape[0] == 1 + 1 + tm.feat_dim
    back, _ = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()}, jm)
    a, b = _flat(jp), _flat(back)
    assert a.keys() == b.keys()
    for path, v in a.items():
        np.testing.assert_array_equal(np.asarray(b[path]), np.asarray(v))

    fresh = CVAE(img_dim=img_dim, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
                 learn_force=True)
    fresh.reset_parameters(torch.Generator().manual_seed(3))
    jp2, _ = convert_state_dict({k: v.numpy() for k, v in fresh.state_dict().items()}, jm)
    again = params_from_jax(jp2, fresh)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(again[k].numpy(), v.numpy(), err_msg=k)


def test_force_optimizer_state_carries_over():
    """optax Adam moments of the force variant map onto the port's Adam
    state through the same maps as the weights."""
    jm, jp, tm = _models(IMG_DIMS[0])
    rng = np.random.default_rng(5)
    st = optax.adam(LR).init(jp)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
    adam = st[0]._replace(count=jnp.int32(4), mu=mu)
    opt = torch.optim.Adam(tm.parameters(), lr=LR)
    sd = opt_state_from_jax((adam,) + tuple(st[1:]), tm, opt)
    want = params_from_jax(adam.mu, tm)
    for i, (name, _) in enumerate(tm.named_parameters()):
        np.testing.assert_array_equal(sd["state"][i]["exp_avg"].numpy(), want[name].numpy())
        assert float(sd["state"][i]["step"]) == 4.0


@pytest.mark.parametrize("img_dim", IMG_DIMS)
@pytest.mark.parametrize("cross", [False, True])
def test_force_forward_matches_jax(img_dim, cross):
    """The force variant's forward, with and without the cross-decode: the
    force head and its logvar (the image logvar) come back from both."""
    jm, jp, tm = _models(img_dim)
    x, y, f, x2, _, _ = _data(img_dim)
    want = jax.jit(jm.apply)(jp, jnp.array(x), jnp.array(y), force=jnp.array(f),
                             x_decode=jnp.array(x2) if cross else None)
    got = tm(torch.from_numpy(x), torch.from_numpy(y), force=torch.from_numpy(f),
             x_decode=torch.from_numpy(x2) if cross else None)
    keys = ["img_pred", "img_logvar", "z_mu", "z_logvar", "z", "force_pred", "force_logvar"]
    if cross:
        keys += ["img_pred_decode", "img_logvar_decode", "force_pred_decode",
                 "force_logvar_decode"]
    assert set(keys) <= set(got)
    for k in keys:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k], 1e-4, 1e-5, k)
    assert float(np.abs(np.asarray(want["force_pred"])).max()) > 0


def test_plain_model_reports_zero_force():
    """Without learn_force the force head is zeros, as in the reference."""
    _, _, tm = _models(IMG_DIMS[0], learn_force=False)
    x, y, _, x2, _, _ = _data(IMG_DIMS[0])
    out = tm(torch.from_numpy(x), torch.from_numpy(y), x_decode=torch.from_numpy(x2))
    assert torch.equal(out["force_pred"], torch.zeros(5, 1))
    assert torch.equal(out["force_pred_decode"], torch.zeros(5, 1))


@pytest.mark.parametrize("other_locs", [False, True])
def test_force_loss_and_gradients_match_jax(other_locs):
    """The force NLL and its cross-decode counterpart: loss and metrics at
    rtol 1e-4, gradients at rtol 1e-3."""
    img_dim = IMG_DIMS[1]
    jm, jp, tm = _models(img_dim)
    x, y, f, x2, y2, f2 = _data(img_dim, b=6, seed=4)
    beta, gamma = 0.03, 0.7
    x_dec = x2 if other_locs else None

    def jloss(p):
        out = jm.apply(p, jnp.array(x), jnp.array(y), force=jnp.array(f),
                       x_decode=None if x_dec is None else jnp.array(x_dec))
        return j_loss(out, jnp.array(y), force=jnp.array(f), y2=jnp.array(y2),
                      force2=jnp.array(f2), beta=beta, gamma=gamma, gamma_weight=0.1,
                      learn_force=True, other_locs=other_locs)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    t = torch.from_numpy
    out = tm(t(x), t(y), force=t(f), x_decode=None if x_dec is None else t(x_dec))
    tl, tmet = cvae_loss(out, t(y), y2=t(y2), beta=beta, gamma=gamma, gamma_weight=0.1,
                         other_locs=other_locs, force=t(f), force2=t(f2), learn_force=True)
    tl.backward()
    _close(tl, jl, 1e-4, 1e-5, "loss")
    for k in jmet:
        _close(tmet[k], jmet[k], 1e-4, 1e-5, k)
    assert "force" in tmet
    want_g = params_from_jax(jg, tm)
    for name, p in tm.named_parameters():
        g = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * np.abs(g).max() + 1e-8, err_msg=name)


def test_force_train_call_step_matched():
    """A 2-step trainer call with learn_force from fed JAX draws: the force
    goes in as input and target, force2 of the cross-decode draw as the
    second target; per-step metrics (force included) at rtol 1e-3."""
    img_dim, B = IMG_DIMS[0], 8
    jm, jp, tm = _models(img_dim)
    rng = np.random.default_rng(0)
    jb = JRB.create(16, S_DIM, img_dim)
    tb = ReplayBuffer.create(16, S_DIM, img_dim, "cpu")
    for _ in range(12):
        x = rng.uniform(-1, 1, S_DIM).astype(np.float32)
        y = rng.uniform(0, 1, img_dim).astype(np.float32)
        f = rng.uniform(0, 30, 1).astype(np.float32)
        jb = jb.push(jnp.array(x), jnp.array(y), jnp.array(f))
        tb.push(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(f))
    key = jax.random.PRNGKey(9)
    draws = jax_train_draws(jm, jp, jb, key, 2, B)
    beta, gamma = 0.01, 0.8
    statics_j = JStatics(model=jm, batch_size=B, num_learning_opt=2, lr=LR)
    _, _, jmet = jax.jit(lambda p, o: j_train(statics_j, p, o, jb, key, beta, gamma))(
        jp, optax.adam(LR).init(jp))
    statics = TrainerStatics(batch_size=B, num_learning_opt=2, lr=LR)
    met = train_call(statics, tm, statics.make_optimizer(tm), tb,
                     torch.tensor(beta), torch.tensor(gamma), draws=draws)
    for k in ("loss", "rc", "kl", "rc_other", "force", "z_activity"):
        assert met[k].shape == (2,)
        _close(met[k], jmet[k], 1e-3, 1e-5, k)
    for k in ("active_units", "active_units_vars"):
        np.testing.assert_array_equal(met[k].numpy(), np.asarray(jmet[k]))


def test_update_dist_force_and_z_ring_over_seven_calls():
    """Seven update_dist calls with forces (the third without one): seed,
    seed_force, z and the whole (z_mem, z_dim) ring after each, newest in
    row 0 and the oldest dropped once the ring is full."""
    img_dim = IMG_DIMS[0]
    jm, jp, tm = _models(img_dim)
    xs, ys, fs, _, _, _ = _data(img_dim, b=7, seed=2)
    js, ts = j_init_state(jm), init_model_state(tm, "cpu")
    assert tuple(ts.z_buff.shape) == (5, Z_DIM)
    upd = jax.jit(lambda st, x, y, f: j_update(jm, jp, st, x, y, f))
    upd_none = jax.jit(lambda st, x, y: j_update(jm, jp, st, x, y))
    for i in range(7):
        if i == 2:
            js, _ = upd_none(js, jnp.array(xs[i]), jnp.array(ys[i]))
            ts, _ = update_dist(tm, ts, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        else:
            js, _ = upd(js, jnp.array(xs[i]), jnp.array(ys[i]), jnp.array(fs[i]))
            ts, _ = update_dist(tm, ts, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]),
                                torch.from_numpy(fs[i]))
        _close(ts.z, js.z, 1e-4, 1e-5, f"call {i} z")
        _close(ts.z_buff, js.z_buff, 1e-4, 1e-5, f"call {i} ring")
        _close(ts.seed_force, js.seed_force, 0, 0, f"call {i} seed_force")
        _close(ts.seed_x, js.seed_x, 0, 0, f"call {i} seed_x")
        assert torch.equal(ts.z_buff[0], ts.z)
    assert float(ts.z_buff.abs().min(1).values.min()) > 0  # the ring is full


@pytest.mark.parametrize("learn_force", [False, True])
def test_ensemble_decode_samples_and_pdf_match_jax(learn_force):
    """After 7 reseeds, decode_samples and pdf with use_z_ensemble decode
    every sample under every ring row and average y_logvar and the image
    features over the ring; the plain pdf stays the newest z's."""
    img_dim = IMG_DIMS[1]
    jm, jp, tm = _models(img_dim, learn_force=learn_force)
    xs, ys, fs, _, _, _ = _data(img_dim, b=7, seed=3)
    js, ts = j_init_state(jm), init_model_state(tm, "cpu")
    for i in range(7):
        f = fs[i] if learn_force else None
        js, _ = j_update(jm, jp, js, jnp.array(xs[i]), jnp.array(ys[i]),
                         None if f is None else jnp.array(f))
        ts, _ = update_dist(tm, ts, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]),
                            None if f is None else torch.from_numpy(f))
    samples = np.random.default_rng(4).uniform(-1, 1, (40, S_DIM)).astype(np.float32)
    s_t, s_j = torch.from_numpy(samples), jnp.array(samples)
    # the port's features flatten (C, h, w), JAX's (h, w, C)
    perm = _feat_perm(tm.inner_shape[1:], tm.inner_shape[0])
    for ens in (True, False):
        jl, jf = jm.apply(jp, js, s_j, use_z_ensemble=ens, method=JCVAE.decode_samples)
        tl, tf = tm.decode_samples(ts, s_t, use_z_ensemble=ens)
        _close(tl, jl, 1e-4, 1e-5, f"ensemble={ens} y_logvar")
        _close(tf[:, perm], jf, 1e-4, 1e-5, f"ensemble={ens} feat")
        want = jm.apply(jp, js, s_j, use_z_ensemble=ens, method=JCVAE.pdf)
        _close(tm.pdf(ts, s_t, use_z_ensemble=ens), want, 1e-4, 1e-6, f"ensemble={ens} pdf")
    # the ensemble is the mean of the ring's single-z decodes
    singles = [tm.decode_samples(dataclasses.replace(ts, z=z), s_t)[0].detach()
               for z in ts.z_buff]
    _close(tm.decode_samples(ts, s_t, use_z_ensemble=True)[0],
           torch.stack(singles).mean(0), 1e-5, 1e-6, "mean of single decodes")

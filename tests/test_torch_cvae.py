"""The port's CVAE, losses and weight converter against the JAX CVAE.

Both sides run from the same weights (JAX init -> ``params_from_jax``) on
inputs made with numpy from a seed. TF32 is off for the f32 comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.cvae import init_model_state as j_init_state, update_dist as j_update
from ealv_tpu.models.losses import cvae_loss as j_loss
from ealv_tpu.utils.torch_import import convert_state_dict
from ealv_tpu_torch.models import CVAE, cvae_loss, init_model_state, update_dist
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

S_DIM, Z_DIM, HIDDEN = 3, 8, (64, 32)
# square toy frames, and a non-square frame whose decoder needs
# output_padding on both axes
IMG_DIMS = [(24, 24, 3), (36, 28, 3)]


def _models(img_dim, dtype="float32"):
    jm = JCVAE(img_dim=img_dim, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
               compute_dtype=jnp.dtype(dtype))
    jp = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, S_DIM)),
                                   jnp.zeros((1, *img_dim)), train=False))(
        jax.random.PRNGKey(0))
    # nonzero biases, so a misplaced bias shows
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    tm = CVAE(img_dim=img_dim, z_dim=Z_DIM, s_dim=S_DIM, hidden_dim=HIDDEN,
              compute_dtype=getattr(torch, dtype))
    tm.load_state_dict(params_from_jax(jp, tm))
    return jm, jp, tm


def _data(img_dim, b=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, S_DIM)).astype(np.float32)
    y = rng.uniform(0, 1, (b, *img_dim)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (b, S_DIM)).astype(np.float32)
    y2 = rng.uniform(0, 1, (b, *img_dim)).astype(np.float32)
    return x, y, x2, y2


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a.detach().float() if torch.is_tensor(a) else a),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("img_dim", IMG_DIMS)
def test_params_round_trip(img_dim):
    """JAX params -> port state_dict -> convert_state_dict -> the same JAX
    params, bit for bit (the maps are permutations and transposes)."""
    jm, jp, tm = _models(img_dim)
    back, _ = convert_state_dict({k: v.numpy() for k, v in tm.state_dict().items()}, jm)
    flat_a = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(v))


def test_reference_key_layout():
    _, _, tm = _models(IMG_DIMS[0])
    keys = set(tm.state_dict())
    for k in ("img_encoder.0.weight", "img_encoder.4.bias", "encode.0.weight",
              "encode.4.weight", "decode.4.bias", "img_decoder.1.weight",
              "img_decoder.5.weight"):
        assert k in keys


@pytest.mark.parametrize("img_dim", IMG_DIMS)
def test_forward_matches_jax_f32(img_dim):
    """f32: the convs sum in another order, rtol 1e-4."""
    jm, jp, tm = _models(img_dim)
    x, y, x2, _ = _data(img_dim)
    want = jax.jit(jm.apply)(jp, jnp.array(x), jnp.array(y), x_decode=jnp.array(x2))
    got = tm(torch.from_numpy(x), torch.from_numpy(y), x_decode=torch.from_numpy(x2))
    for k in ("img_pred", "img_logvar", "z_mu", "z_logvar", "z",
              "img_pred_decode", "img_logvar_decode"):
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k], rtol=1e-4, atol=1e-5)


def test_reparameterized_forward_matches_jax():
    """The JAX noise, recovered as (z - z_mu) * exp(-z_logvar / 2), fed to
    the port gives the same latent."""
    img_dim = IMG_DIMS[0]
    jm, jp, tm = _models(img_dim)
    x, y, _, _ = _data(img_dim, seed=1)
    want = jm.apply(jp, jnp.array(x), jnp.array(y), train=True,
                    rngs={"reparam": jax.random.PRNGKey(3)})
    eps = (np.asarray(want["z"]) - np.asarray(want["z_mu"])) \
        * np.exp(-0.5 * np.asarray(want["z_logvar"]))
    got = tm(torch.from_numpy(x), torch.from_numpy(y), train=True,
             eps=torch.from_numpy(eps))
    _close(got["z"], want["z"], rtol=1e-4, atol=1e-5)
    _close(got["img_pred"], want["img_pred"], rtol=1e-4, atol=1e-5)


def test_pdf_and_update_dist_match_jax():
    img_dim = IMG_DIMS[1]
    jm, jp, tm = _models(img_dim)
    x, y, _, _ = _data(img_dim, b=1, seed=2)
    samples = np.random.default_rng(3).uniform(-1, 1, (40, S_DIM)).astype(np.float32)

    js = j_init_state(jm)
    ts = init_model_state(tm, "cpu")
    # before the first sample the target is uniform
    np.testing.assert_array_equal(
        tm.pdf(ts, torch.from_numpy(samples)).numpy(),
        np.asarray(jm.apply(jp, js, jnp.array(samples), method=JCVAE.pdf)))

    js, _ = j_update(jm, jp, js, jnp.array(x[0]), jnp.array(y[0]))
    ts, _ = update_dist(tm, ts, torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    _close(ts.z, js.z, rtol=1e-4, atol=1e-5)
    _close(ts.seed_x, js.seed_x, rtol=0, atol=0)
    _close(ts.seed_y, js.seed_y, rtol=0, atol=0)
    assert bool(ts.initialized) and bool(js.initialized)
    want = jm.apply(jp, js, jnp.array(samples), method=JCVAE.pdf)
    _close(tm.pdf(ts, torch.from_numpy(samples)), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("img_dim", IMG_DIMS)
def test_loss_and_gradients_match_jax_f32(img_dim):
    """Loss at rtol 1e-4; parameter gradients at rtol 1e-3 (conv weight
    gradients sum over the batch and the image in another order)."""
    jm, jp, tm = _models(img_dim)
    x, y, x2, y2 = _data(img_dim, b=6, seed=4)
    beta, gamma = 0.03, 0.7

    def jloss(p):
        out = jm.apply(p, jnp.array(x), jnp.array(y), x_decode=jnp.array(x2))
        return j_loss(out, jnp.array(y), y2=jnp.array(y2), beta=beta, gamma=gamma,
                      gamma_weight=0.1, other_locs=True)

    (jl, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    out = tm(torch.from_numpy(x), torch.from_numpy(y), x_decode=torch.from_numpy(x2))
    tl, tmet = cvae_loss(out, torch.from_numpy(y), y2=torch.from_numpy(y2), beta=beta,
                         gamma=gamma, gamma_weight=0.1, other_locs=True)
    tl.backward()
    for k in ("loss", "rc", "kl", "rc_other"):
        _close(tmet[k], jmet[k], rtol=1e-4, atol=1e-5)
    # gradients share the parameters' layout, so the converter maps them
    want = params_from_jax(jg, tm)
    for name, p in tm.named_parameters():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * np.abs(g).max() + 1e-7, err_msg=name)


def test_forward_and_loss_match_jax_bf16():
    """bf16: both sides round every layer's inputs and outputs to 8
    mantissa bits, at places that differ in detail (bias adds, the
    accumulator's width), so the agreement is ~2e-2 relative."""
    img_dim = IMG_DIMS[0]
    jm, jp, tm = _models(img_dim, dtype="bfloat16")
    x, y, x2, y2 = _data(img_dim, seed=5)
    want = jax.jit(jm.apply)(jp, jnp.array(x), jnp.array(y), x_decode=jnp.array(x2))
    got = tm(torch.from_numpy(x), torch.from_numpy(y), x_decode=torch.from_numpy(x2))
    assert got["img_pred"].dtype == torch.bfloat16
    assert got["z_mu"].dtype == torch.float32 and got["img_logvar"].dtype == torch.float32
    for k in ("img_pred", "img_logvar", "z_mu", "z_logvar", "img_pred_decode"):
        _close(got[k], np.asarray(want[k], np.float32), rtol=2e-2, atol=2e-2)
    jl, _ = j_loss(want, jnp.array(y), y2=jnp.array(y2), beta=0.01, gamma=0.5,
                   other_locs=True)
    tl, _ = cvae_loss(got, torch.from_numpy(y), y2=torch.from_numpy(y2), beta=0.01,
                      gamma=0.5, other_locs=True)
    _close(tl, jl, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kwargs", [dict(decoder_mode="subpixel"),
                                    dict(decoder_mode="resize_conv"),
                                    dict(lane_pad=8), dict(fast_encoder_grads="s2d"),
                                    dict(fast_encoder_grads="im2col"),
                                    dict(fast_encoder_grads=True)])
def test_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError):
        CVAE(img_dim=(24, 24, 3), **kwargs)


def test_random_init_follows_flax_law():
    """Port init: truncated lecun-normal weights, zero biases, as flax."""
    tm = CVAE(img_dim=(24, 24, 3), s_dim=S_DIM, hidden_dim=HIDDEN)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    w = tm.decode[2].weight.detach()  # Linear (64, 32): fan_in 32
    std = (1 / 32) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    assert abs(float(w.std()) - (1 / 32) ** 0.5) < 0.1 * (1 / 32) ** 0.5
    assert all(float(b.detach().abs().max()) == 0 for n, b in tm.named_parameters()
               if n.endswith("bias"))

"""The whole CVAE under each option, the port against the JAX CVAE: the
forward, the loss and its gradients, and one deterministic trainer call.

Options: the ``"subpixel"`` and ``"resize_conv"`` decoders (the latter also
with even kernels, where SAME pads one more on the high side), the encoder
schedules ``True``, ``"s2d"`` and ``"im2col"``, ``lane_pad`` 8 and 32, and
``lane_pad`` with a schedule or another decoder (the schedule takes the
encoder, the other decoders are not padded). Frames of 45x45 (decoder
deficits 2, 1 and 0) and 24x24 (0, 0 and 1). Both sides run from the same
weights (JAX init -> ``params_from_jax``) on inputs made with numpy from a
seed.

Tolerances: f32 (TF32 off) outputs and loss at rtol 1e-4, atol 1e-5, the
gradients at rtol 1e-3 with atol 1e-3 of each tensor's largest entry, as
``test_torch_trainer.py`` holds them; bf16 outputs and loss at 2e-2, as
``test_torch_cvae.py`` holds the default model (both sides round every
layer to 8 mantissa bits, at places that differ in detail).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.models import CVAE as JCVAE
from ealv_tpu.models.losses import cvae_loss as j_loss
from ealv_tpu_torch.models import CVAE, cvae_loss
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

S, Z, HID = 2, 6, (32, 16)
OPTIONS = {
    "subpixel": dict(decoder_mode="subpixel"),
    "resize_conv": dict(decoder_mode="resize_conv"),
    "resize_conv_even": dict(decoder_mode="resize_conv", cnn_kernels=(4, 3, 4)),
    "s2d_true": dict(fast_encoder_grads=True),
    "s2d": dict(fast_encoder_grads="s2d"),
    "im2col": dict(fast_encoder_grads="im2col"),
    "lane8": dict(lane_pad=8),
    "lane32": dict(lane_pad=32),
    "lane8_s2d": dict(lane_pad=8, fast_encoder_grads="s2d"),
    "lane8_im2col": dict(lane_pad=8, fast_encoder_grads="im2col"),
    "lane8_subpixel": dict(lane_pad=8, decoder_mode="subpixel"),
    "lane8_resize_conv": dict(lane_pad=8, decoder_mode="resize_conv"),
}


def _models(img_dim, opts, dtype="float32", learn_force=False):
    kw = dict(img_dim=img_dim, z_dim=Z, s_dim=S, hidden_dim=HID, learn_force=learn_force,
              **opts)
    jm = JCVAE(compute_dtype=jnp.dtype(dtype), **kw)
    jp = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, S)),
                                   jnp.zeros((1, *img_dim)),
                                   jnp.zeros((1, 1)) if learn_force else None,
                                   train=False))(jax.random.PRNGKey(0))
    # nonzero biases, so a misplaced bias (or a padded channel that is not
    # zero) shows
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    tm = CVAE(compute_dtype=getattr(torch, dtype), **kw)
    tm.load_state_dict(params_from_jax(jp, tm))
    return jm, jp, tm


def _data(img_dim, b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, S)).astype(np.float32),
            rng.uniform(0, 1, (b, *img_dim)).astype(np.float32),
            rng.uniform(-1, 1, (b, S)).astype(np.float32),
            rng.uniform(0, 1, (b, *img_dim)).astype(np.float32),
            rng.uniform(-1, 1, (b, 1)).astype(np.float32),
            rng.uniform(-1, 1, (b, 1)).astype(np.float32))


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(a.detach().float()), np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


KEYS = ("img_pred", "img_logvar", "z_mu", "z_logvar", "img_pred_decode", "force_pred")


@pytest.mark.parametrize("img_dim", [(45, 45, 3), (24, 24, 3)])
@pytest.mark.parametrize("name", list(OPTIONS))
def test_forward_and_grads_match_jax_f32(name, img_dim):
    """Forward with the cross-decode, loss, and the loss's gradient for
    every parameter; the force variant, so its encoder column and decoder
    row cross too."""
    jm, jp, tm = _models(img_dim, OPTIONS[name], learn_force=True)
    x, y, x2, y2, f, f2 = _data(img_dim)
    kw = dict(beta=0.01, gamma=0.5, gamma_weight=0.1, other_locs=True, learn_force=True)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(f),
                       x_decode=jnp.asarray(x2))
        return j_loss(out, jnp.asarray(y), y2=jnp.asarray(y2), force=jnp.asarray(f),
                      force2=jnp.asarray(f2), **kw)[0], out

    (jl, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    got = tm(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(f),
             x_decode=torch.from_numpy(x2))
    for k in KEYS:
        assert tuple(got[k].shape) == want[k].shape, k
        _close(got[k], want[k], 1e-4, 1e-5, k)
    tl, _ = cvae_loss(got, torch.from_numpy(y), y2=torch.from_numpy(y2),
                      force=torch.from_numpy(f), force2=torch.from_numpy(f2), **kw)
    _close(tl, jl, 1e-4, 1e-5, "loss")
    tl.backward()
    want_g = params_from_jax(jg, tm)
    for pname, p in tm.named_parameters():
        g = want_g[pname].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-3 * np.abs(g).max() + 1e-8, err_msg=pname)

"""The CVAE's options in bf16 and in the trainer, the port against the JAX
package: the bf16 forward and loss per option, and one deterministic Adam
step of the trainer call per option (options and tolerances as in
``test_torch_model_options_cvae.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ealv_tpu.data.replay import ReplayBuffer as JRB
from ealv_tpu.models.losses import cvae_loss as j_loss
from ealv_tpu.runtime.trainer import TrainerStatics as JStatics, train_call as j_train
from ealv_tpu_torch.data.replay import ReplayBuffer
from ealv_tpu_torch.models import cvae_loss
from ealv_tpu_torch.runtime.trainer import TrainerStatics, train_call
from test_torch_model_options_cvae import KEYS, OPTIONS, S, _close, _data, _models
from test_torch_trainer import _compare_params, jax_train_draws, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("name", ["subpixel", "resize_conv", "s2d", "im2col", "lane8",
                                  "lane8_s2d"])
def test_forward_and_loss_match_jax_bf16(name):
    """bf16 at 45x45: the outputs and the loss at 2e-2, and the image
    prediction in bf16 on both sides."""
    img_dim = (45, 45, 3)
    jm, jp, tm = _models(img_dim, OPTIONS[name], dtype="bfloat16")
    x, y, x2, y2, _, _ = _data(img_dim, seed=5)
    want = jax.jit(jm.apply)(jp, jnp.asarray(x), jnp.asarray(y), x_decode=jnp.asarray(x2))
    got = tm(torch.from_numpy(x), torch.from_numpy(y), x_decode=torch.from_numpy(x2))
    assert got["img_pred"].dtype == torch.bfloat16 and want["img_pred"].dtype == jnp.bfloat16
    for k in KEYS[:-1]:
        _close(got[k], want[k], 2e-2, 2e-2, k)
    kw = dict(beta=0.01, gamma=0.5, other_locs=True)
    jl, _ = j_loss(want, jnp.asarray(y), y2=jnp.asarray(y2), **kw)
    tl, _ = cvae_loss(got, torch.from_numpy(y), y2=torch.from_numpy(y2), **kw)
    _close(tl, jl, 2e-2, 2e-2, "loss")
    tl.backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())


@pytest.mark.parametrize("name", ["subpixel", "resize_conv", "s2d_true", "im2col",
                                  "lane8", "lane8_s2d"])
def test_one_deterministic_trainer_call(name):
    """One Adam step of train_call(deterministic=True) on both sides from
    the same weights and ring, the JAX batch draws fed to the port: the
    metrics at rtol 1e-4, the parameters as test_torch_trainer.py compares
    them (tight where the JAX gradient is clear of rounding, within 2 lr
    everywhere)."""
    img, b, lr = (24, 24, 3), 8, 1e-3
    jm, jp, tm = _models(img, OPTIONS[name])
    rng = np.random.default_rng(0)
    jb = JRB.create(16, S, img)
    tb = ReplayBuffer.create(16, S, img, "cpu")
    for _ in range(12):
        x = rng.uniform(-1, 1, S).astype(np.float32)
        y = rng.uniform(0, 1, img).astype(np.float32)
        jb = jb.push(jnp.asarray(x), jnp.asarray(y))
        tb.push(torch.from_numpy(x), torch.from_numpy(y))
    key = jax.random.PRNGKey(5)
    draws = jax_train_draws(jm, jp, jb, key, 1, b)
    beta, gamma = 0.02, 0.4
    i1, i2 = jnp.asarray(draws.idx[0].numpy()), jnp.asarray(draws.idx2[0].numpy())

    def jloss(p):
        out = jm.apply(p, jb.x[i1], jb.y[i1], x_decode=jb.x[i2])
        return j_loss(out, jb.y[i1], y2=jb.y[i2], beta=beta, gamma=gamma,
                      gamma_weight=0.1, other_locs=True)[0]

    jgrad = jax.jit(jax.grad(jloss))(jp)
    statics_j = JStatics(model=jm, batch_size=b, num_learning_opt=1, lr=lr)
    jp1, _, jmet = jax.jit(lambda p, o: j_train(statics_j, p, o, jb, key, beta, gamma,
                                                deterministic=True))(
        jp, optax.adam(lr).init(jp))
    statics = TrainerStatics(batch_size=b, num_learning_opt=1, lr=lr)
    met = train_call(statics, tm, statics.make_optimizer(tm), tb, torch.tensor(beta),
                     torch.tensor(gamma), deterministic=True, draws=draws)
    for k in ("loss", "rc", "kl", "rc_other", "z_activity"):
        np.testing.assert_allclose(met[k].numpy(), np.asarray(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _compare_params(tm, jp1, jgrad, steps=1)

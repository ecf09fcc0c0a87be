"""The post-exploration training phase: the port's
``Experiment.post_train_chunk`` against the JAX package's, step-matched.

Both experiments run with both trainer kernels switched on
(``fast_encoder_grads="pallas"``, ``fused_adam=True``; the JAX Pallas wgrad
in interpret mode) and start from the same state: weights converted with
``params_from_jax``, the same six samples pushed to both replay rings, and
the JAX model state copied over. Each JAX call's draws (the entropy
grade's uniform samples, the batch indices and the reparam noise) are
derived from its keys with the JAX package's own functions and fed to the
port, as ``test_torch_tick.py`` does for ticks. f32, TF32 off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ealv_tpu.models.cvae import update_dist as j_update_dist
from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.models.cvae import ModelState
from ealv_tpu_torch.ops import FusedAdam
from ealv_tpu_torch.runtime import Experiment, PostTrainDraws
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_trainer import jax_train_draws, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2,
           compute_dtype="float32", fast_encoder_grads="pallas")
N_FILLED = 6


def _experiments():
    exp_j = JExperiment(JConfig(**TOY), train_calls_per_tick=1)
    exp_t = Experiment(ExperimentConfig(**TOY), train_calls_per_tick=1, device="cpu")
    exp_j.trainer = dataclasses.replace(exp_j.trainer, fused_adam=True)
    exp_t.trainer = dataclasses.replace(exp_t.trainer, fused_adam=True)
    es_j, es_t = exp_j.init(seed=0), exp_t.init(seed=0)
    es_t.model.load_state_dict(params_from_jax(es_j.params, es_t.model))
    assert isinstance(es_t.opt, FusedAdam)

    rng = np.random.default_rng(0)
    lo, hi = exp_t.cfg.robot_lim[:, 0], exp_t.cfg.robot_lim[:, 1]
    buf = es_j.buf
    for _ in range(N_FILLED):
        x = rng.uniform(lo, hi).astype(np.float32)
        y = rng.uniform(0, 1, TOY["image_dim"]).astype(np.float32)
        buf = buf.push(jnp.asarray(x), jnp.asarray(y))
        es_t.buf.push(torch.from_numpy(x), torch.from_numpy(y))
    ms, _ = j_update_dist(exp_j.model, es_j.params, es_j.mstate, jnp.asarray(x),
                          jnp.asarray(y))
    es_j = es_j._replace(buf=buf, mstate=ms, explr_step=jnp.int32(N_FILLED),
                         learning_ind=jnp.int32(3))
    es_t.mstate = ModelState(seed_x=torch.tensor(np.asarray(ms.seed_x)),
                             seed_y=torch.tensor(np.asarray(ms.seed_y)),
                             seed_force=torch.tensor(np.asarray(ms.seed_force)),
                             z=torch.tensor(np.asarray(ms.z)),
                             z_buff=torch.tensor(np.asarray(ms.z_buff)),
                             initialized=torch.tensor(True))
    es_t.explr_step, es_t.learning_ind = N_FILLED, 3
    return exp_j, es_j, exp_t, es_t


def _jax_call_draws(exp, es):
    """The draws of one JAX post-training call from ``es``."""
    cfg = exp.cfg
    _, k_train, k_hp = jax.random.split(es.key, 3)
    samples = jax.random.uniform(k_hp, (cfg.num_target_samples, cfg.s_dim),
                                 minval=exp.robot_lim[:, 0], maxval=exp.robot_lim[:, 1])
    train = jax_train_draws(exp.model, es.params, es.buf, k_train,
                            cfg.num_learning_opt, cfg.batch_size)
    return PostTrainDraws(samples=torch.tensor(np.asarray(samples)), train=train)


def test_two_calls_step_matched():
    """Loss, beta and gamma of each call at rtol 1e-3 (beta is a power of
    ten of the entropy, gamma a coverage mean; f32 on both sides), the
    hyperparameter ring at rtol 1e-3, the counters exactly, and the
    parameters within 2 * lr * steps (4 Adam steps)."""
    exp_j, es_j, exp_t, es_t = _experiments()
    post_j = jax.jit(lambda s: exp_j.post_train_chunk(s, 1))
    draws, infos_j = [], []
    for _ in range(2):
        draws.append(_jax_call_draws(exp_j, es_j))
        es_j, info = post_j(es_j)
        infos_j.append(info)
    es_t, info_t = exp_t.post_train_chunk(es_t, 2, draws)

    for key in ("loss", "beta", "gamma"):
        want = np.concatenate([np.asarray(i[key]) for i in infos_j])
        assert info_t[key].shape == (2,)
        np.testing.assert_allclose(info_t[key].numpy(), want, rtol=1e-3, atol=1e-7,
                                   err_msg=key)
    assert es_t.learning_ind == int(es_j.learning_ind) == 5
    assert es_t.hyper.iter == int(es_j.hyper.iter) == 4
    assert es_t.opt.param_groups[0]["step"] == int(es_j.opt_state.count) == 4
    assert int(es_t.buf.beta_size) == int(es_j.buf.beta_size) == 2
    np.testing.assert_allclose(es_t.buf.beta.numpy(), np.asarray(es_j.buf.beta), rtol=1e-3)
    np.testing.assert_allclose(es_t.buf.gamma.numpy(), np.asarray(es_j.buf.gamma), rtol=1e-3)
    want = params_from_jax(es_j.params, es_t.model)
    for name, p in es_t.model.named_parameters():
        assert np.abs(p.detach().numpy() - want[name].numpy()).max() <= 2 * 1e-3 * 4 + 1e-6
    assert es_t.explr_step == N_FILLED  # no exploration


def test_own_draws_learn_and_leave_the_ring_alone():
    """Without fed draws the calls draw from the trainer's generator: the
    counters advance, beta and gamma are finite, the loss falls, and the
    replay ring is read only."""
    _, _, exp_t, es_t = _experiments()
    x0, y0 = es_t.buf.x.clone(), es_t.buf.y.clone()
    es_t, first = exp_t.post_train_chunk(es_t, 3)
    es_t, last = exp_t.post_train_chunk(es_t, 3)
    assert es_t.learning_ind == 9 and es_t.hyper.iter == 12
    assert all(torch.isfinite(v).all() for v in (*first.values(), *last.values()))
    assert float(last["loss"].mean()) < float(first["loss"].mean())
    assert torch.equal(es_t.buf.x, x0) and torch.equal(es_t.buf.y, y0)
    assert es_t.buf.size == N_FILLED

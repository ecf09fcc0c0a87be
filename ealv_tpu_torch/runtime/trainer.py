"""Trainer call, the learning half of the loop (port of
``ealv_tpu/runtime/trainer.py``): ``num_learning_opt`` Adam steps on
weighted batches with the cross-decode loss and the latent diagnostics.
With the force variant the sampled forces are the encoder's input and the
force head's target, the cross-decode draw's forces its second target.

``torch.optim.Adam`` computes the same update as ``optax.adam`` (eps_root
0); on the card it is ``capturable`` (its bias corrections from step
counts on the device, in another order of operations than the host
path's). ``fused_adam=True`` swaps in ``FusedAdam``, whose step is one launch of
the multi-tensor Adam kernel K2 (``ops/adam.py``) over every parameter. As
in the JAX package the switch is off by default; a user turns it on with
``dataclasses.replace(exp.trainer, fused_adam=True)`` before ``exp.init``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import CVAE, cvae_loss
from ..data.replay import ReplayBuffer
from ..ops.adam import FusedAdam


@dataclasses.dataclass(frozen=True)
class TrainerStatics:
    """Static half of the trainer: model architecture and sizes."""

    batch_size: int = 64
    num_learning_opt: int = 25
    gamma_weight: float = 0.1
    other_locs: bool = True
    lr: float = 1e-3
    fused_adam: bool = False  # K2: one Adam kernel launch per step

    def make_optimizer(self, model: CVAE) -> torch.optim.Optimizer:
        """``FusedAdam`` (K2) or the stock ``torch.optim.Adam``; on the card
        the stock one is ``capturable``, its step counts on the device as
        the JAX optimizer's count is, so that a trainer call captured in a
        step (``runtime/graphs.py``) advances them on every replay."""
        if self.fused_adam:
            return FusedAdam(model.parameters(), lr=self.lr)
        capturable = next(model.parameters()).is_cuda
        return torch.optim.Adam(model.parameters(), lr=self.lr, capturable=capturable)


@dataclasses.dataclass
class TrainDraws:
    """One trainer call's random draws, fed instead of drawn: batch indices
    (steps, B), cross-decode indices (steps, B) and reparam noise
    (steps, B / num_shards, z_dim)."""

    idx: torch.Tensor
    idx2: torch.Tensor
    eps: torch.Tensor


def train_call(statics: TrainerStatics, model: CVAE, opt, buf: ReplayBuffer,
               beta, gamma, generator: torch.Generator | None = None,
               weighted: bool = True, deterministic: bool = False,
               draws: TrainDraws | None = None, grad_transform=None,
               num_shards: int = 1, shard: int = 0):
    """One trainer call of ``num_learning_opt`` steps; updates ``model`` in
    place through ``opt``. ``deterministic`` decodes z = z_mu (no noise).
    Returns the metrics, each stacked to (num_learning_opt,).

    The data-parallel seams (``parallel/train.py``): ``grad_transform``
    takes the list of gradients between ``backward`` and the optimizer step
    and rewrites them in place (the cross-rank mean). With ``num_shards``
    every shard draws the same global batch of ``batch_size`` indices (the
    same generator state on every rank) and trains on its rows ``[shard *
    bpp, (shard + 1) * bpp)``, bpp = batch_size / num_shards; the reparam
    noise is one (bpp, z_dim) block, the same on every shard, as in the JAX
    package. Fed ``draws`` hold global indices and one noise block a step."""
    B = statics.batch_size
    bpp = B // num_shards
    mine = slice(shard * bpp, (shard + 1) * bpp)
    rows = []
    for step in range(statics.num_learning_opt):
        if draws is not None:
            idx, idx2, eps = draws.idx[step], draws.idx2[step], draws.eps[step]
        else:
            idx = buf.sample_indices(B, weighted=weighted, generator=generator)
            idx2 = (buf.sample_indices(B, weighted=False, generator=generator)
                    if statics.other_locs else None)
            eps = None
        idx = idx[mine]
        idx2 = idx2[mine] if idx2 is not None else None
        x, y, force = buf.x[idx], buf.y[idx], buf.force[idx]
        x_dec = y2 = force2 = None
        if statics.other_locs:
            x2, y2, force2 = buf.x[idx2], buf.y[idx2], buf.force[idx2]
            x_dec = x2 - x if model.dx else x2
        out = model(x, y, force=force if model.learn_force else None, x_decode=x_dec,
                    train=not deterministic, eps=eps, generator=generator)
        loss, m = cvae_loss(out, y, y2=y2, beta=beta, gamma=gamma,
                            gamma_weight=statics.gamma_weight,
                            other_locs=statics.other_locs, force=force,
                            force2=force2, learn_force=model.learn_force)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if grad_transform is not None:
            grad_transform([p.grad for p in model.parameters() if p.grad is not None])
        opt.step()

        thr = 0.01
        z_mu, z_logvar = out["z_mu"].detach(), out["z_logvar"].detach()
        vars_of_means = z_mu.var(0, correction=0)
        means_of_vars = torch.exp(z_logvar).mean(0)
        row = {
            "loss": loss.detach(),
            "rc": m["rc"].detach(),
            "kl": m["kl"].detach(),
            "z_activity": vars_of_means.sum(),
            "active_units": (vars_of_means > thr).sum(),
            "active_units_vars": (means_of_vars < thr).sum(),
        }
        if statics.other_locs:
            row["rc_other"] = m["rc_other"].detach()
        if model.learn_force:
            row["force"] = m["force"].detach()
        rows.append(row)
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

"""Data-parallel training and sample-parallel decoding (port of
``ealv_tpu/parallel/train.py``).

Every rank runs the same replicated model, optimizer, replay ring and
generators from the same seed, as every shard of the JAX ``shard_map``
program does. ``dp_train_call`` splits each global batch into one slice per
rank and averages the gradients over the ranks between ``backward`` and the
optimizer step: one ``all_reduce`` of one flat buffer per Adam step. Every
rank then applies the same averaged gradient, so the parameters stay
bit-equal across ranks. ``sharded_pdf`` decodes one slice of the candidate
samples per rank and gathers the slices back in order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..data.replay import ReplayBuffer
from ..models import CVAE
from ..runtime.trainer import TrainerStatics, TrainDraws, train_call
from .mesh import Mesh


def _mean_over_ranks(mesh: Mesh):
    """A ``grad_transform`` that replaces each gradient by its mean over the
    ranks, in place: one flat buffer, one ``all_reduce``, copied back into
    the same ``.grad`` tensors (K2's launch table keeps its entries)."""

    def transform(grads: list[torch.Tensor]) -> None:
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in grads]), grads)])

    return transform


def dp_train_call(statics: TrainerStatics, mesh: Mesh, model: CVAE, opt,
                  buf: ReplayBuffer, beta, gamma,
                  generator: torch.Generator | None = None, weighted: bool = True,
                  deterministic: bool = False, draws: TrainDraws | None = None):
    """One trainer call data-parallel over ``mesh``: this rank trains on its
    ``batch_size / n`` rows of every global batch, the gradients are
    averaged over the ranks before each step, and the metrics are averaged
    over the ranks once at the end (each keeps its per-shard meaning: e.g.
    ``z_activity`` is the mean over shards of each shard's latent variance).
    As in the JAX package every shard draws the same reparam noise, one
    (batch_size / n, z_dim) block; fed ``draws`` carry one such block a
    step. Returns the metrics as float32, each stacked to
    (num_learning_opt,)."""
    n = mesh.size
    if statics.batch_size % n:
        raise ValueError(f"batch_size {statics.batch_size} not divisible by {n}")
    metrics = train_call(statics, model, opt, buf, beta, gamma, generator=generator,
                         weighted=weighted, deterministic=deterministic, draws=draws,
                         grad_transform=_mean_over_ranks(mesh), num_shards=n,
                         shard=mesh.rank)
    stacked = torch.stack([v.float() for v in metrics.values()])
    dist.all_reduce(stacked, group=mesh.group)
    stacked /= n
    return dict(zip(metrics, stacked.unbind(0)))


@torch.no_grad()
def sharded_pdf(model: CVAE, mesh: Mesh, mstate, samples):
    """``model.pdf`` with the candidate samples split over the ranks: this
    rank decodes its ``N / n`` rows and the slices come back in order, by
    an ``all_reduce`` of each rank's slice in a zeroed buffer (adding zeros
    is exact, and gloo gathers CUDA tensors only this way)."""
    n, r = mesh.size, mesh.rank
    N = samples.shape[0]
    if N % n:
        raise ValueError(f"{N} samples not divisible by {n}")
    k = N // n
    local = model.pdf(mstate, samples[r * k:(r + 1) * k])
    out = local.new_zeros((N,) + local.shape[1:])
    out[r * k:(r + 1) * k] = local
    dist.all_reduce(out, group=mesh.group)
    return out

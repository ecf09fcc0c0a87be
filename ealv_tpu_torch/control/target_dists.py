"""Target distributions for the planner (port of ``GaussianMixtureDist``
and ``prior_dist`` of ``ealv_tpu/control/target_dists.py``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GaussianMixtureDist(NamedTuple):
    """Sum of diagonal Gaussians plus a floor."""

    means: torch.Tensor  # (K, d)
    vars: torch.Tensor  # (K, d) diagonal covariance
    floor: float = 0.0

    def pdf(self, samples):
        d = self.means.shape[1]
        diff = samples[:, None, :] - self.means[None, :, :]  # (N, K, d)
        maha = (diff ** 2 / self.vars[None]).sum(-1)
        log_norm = -0.5 * (d * math.log(2 * math.pi) + torch.log(self.vars).sum(-1))
        return torch.exp(-0.5 * maha + log_norm[None, :]).sum(1) + self.floor


def prior_dist(states: str, device="cuda") -> GaussianMixtureDist:
    """The reference's hardcoded two-object scene prior."""
    base_states = "xyzrpw"
    base_duck = [-0.8, -0.8, -0.15, 3.6, 0.5, 0.0]
    base_ball = [0.6, 0.9, -0.15, 2.6, -0.5, 0.0]
    base_covar = [0.2, 0.2, 0.5, 0.2, 0.2, 0.5]
    pick = lambda base, other: [base[base_states.rfind(s)] if s in base_states
                                else other for s in states]
    covar = pick(base_covar, 1.0)
    return GaussianMixtureDist(
        means=torch.tensor([pick(base_duck, 0.0), pick(base_ball, 0.0)], device=device),
        vars=torch.tensor([covar, covar], device=device),
        floor=1e-5,
    )

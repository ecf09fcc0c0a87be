"""Target distributions for the planner (port of
``ealv_tpu/control/target_dists.py``): each has ``pdf(samples (N, d)) ->
(N,)``, an unnormalized density."""

from __future__ import annotations

import dataclasses
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


def gaussian_dist(center, covar_diag, floor: float = 0.0,
                  device="cuda") -> GaussianMixtureDist:
    """One diagonal Gaussian (the planner demo's target)."""
    t = lambda v: torch.atleast_2d(torch.as_tensor(v, dtype=torch.float32, device=device))
    return GaussianMixtureDist(means=t(center), vars=t(covar_diag), floor=floor)


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


class UniformDist(NamedTuple):
    """Constant density."""

    dim: int = 2

    def pdf(self, samples):
        val = samples.new_ones(samples.shape[0])
        return val / val.sum() + 1e-5


@dataclasses.dataclass
class ExplrDist:
    """A ring of pushed (mean, std) Gaussians; pdf = their mean density,
    uniform before the first push. ``invert`` flips it (-d + max d + min d)
    to steer away from the pushed points. ``push`` returns a new ring and
    keeps ``size`` on the device, so it never waits for it."""

    means: torch.Tensor  # (cap, d)
    stds: torch.Tensor  # (cap, d)
    size: torch.Tensor  # () int64
    invert: bool = False

    @classmethod
    def create(cls, capacity: int, dim: int, invert: bool = False, device="cuda"):
        return cls(means=torch.zeros((capacity, dim), device=device),
                   stds=torch.ones((capacity, dim), device=device),
                   size=torch.zeros((), dtype=torch.int64, device=device),
                   invert=invert)

    def push(self, mean, std) -> "ExplrDist":
        cap = self.means.shape[0]
        slot = (torch.arange(cap, device=self.means.device) == self.size % cap)[:, None]
        return dataclasses.replace(
            self, means=torch.where(slot, mean, self.means),
            stds=torch.where(slot, std, self.stds), size=(self.size + 1).clamp(max=cap))

    def pdf(self, samples):
        cap = self.means.shape[0]
        diff = samples[:, None, :] - self.means[None]  # (N, cap, d)
        comp = torch.exp(-0.5 * (diff ** 2 / self.stds[None]).sum(-1))
        mask = (torch.arange(cap, device=samples.device) < self.size).float()
        dist = (comp * mask[None, :]).sum(1) / self.size.clamp(min=1)
        if self.invert:
            dist = -dist + dist.max() + dist.min()
        uniform = samples.new_ones(samples.shape[0]) / samples.shape[0] + 1e-5
        return torch.where(self.size > 0, dist, uniform)

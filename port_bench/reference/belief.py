"""Bayesian belief grids for object re-localization in plain torch: a
frozen copy of ``ealv_tpu_torch/fingerprint/belief.py`` (the grid, the
ring of pending measurements, the precision-weighted fusion and the
multilinear pdf) and of the identification's belief entropy
(``fingerprint/test_runtime.py``), all in float32.

A belief is a value: ``push`` and ``update_prior`` return a new one."""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .kernels import renormalize


def _rescale(x, old, new):
    return (x - old[0]) / (old[1] - old[0]) * (new[1] - new[0]) + new[0]


def grid_for(explr_states: str, lims, num_samples: int, device):
    """(grid (G, d), widened limits (d, 2), kernel scale) of a belief over
    ``lims`` (d, 2): the yaw limits widened 1.33x, then all of them 1.15x;
    ``np.meshgrid``'s ('xy' indexing) over ``num_samples`` points a
    dimension; the scale 2.5 times the widest mesh spacing."""
    lims = np.asarray(lims, np.float64).copy()
    if "w" in explr_states:
        lims[explr_states.rfind("w")] *= 1.33
    lims = lims * 1.15
    axes = [np.linspace(lo, hi, num_samples) for lo, hi in lims]
    grid = np.stack([m.ravel() for m in np.meshgrid(*axes)], axis=1)
    scale = float(np.max([a[1] - a[0] for a in axes]) * 2.5)
    f32 = dict(dtype=torch.float32, device=device)
    return torch.tensor(grid, **f32), torch.tensor(lims, **f32), scale


@dataclasses.dataclass
class Belief:
    grid: torch.Tensor  # (G, d)
    lims: torch.Tensor  # (d, 2) widened limits
    prior: torch.Tensor  # (G,)
    prior_var: torch.Tensor  # (G,)
    meas_loc: torch.Tensor  # (cap, d) pending measurements
    meas_val: torch.Tensor  # (cap,)
    meas_n: torch.Tensor  # () int64 pending count
    count: torch.Tensor  # () int64 fused so far
    num_samples: int
    scale: float
    thresh: float
    clip: float

    @property
    def capacity(self) -> int:
        return self.meas_loc.shape[0]

    def push(self, state, val) -> "Belief":
        """One pending measurement at the ring's next slot (the count
        modulo the capacity; the count stops at the capacity)."""
        cap = self.capacity
        slot = int(self.meas_n) % cap
        loc, v = self.meas_loc.clone(), self.meas_val.clone()
        loc[slot], v[slot] = state, val
        return dataclasses.replace(self, meas_loc=loc, meas_val=v,
                                   meas_n=(self.meas_n + 1).clamp(max=cap))

    def update_prior(self) -> "Belief":
        """The pending measurements fused into the prior (a Gaussian
        footprint of each over the grid, a precision-weighted update); the
        ring emptied. Unchanged without pending measurements."""
        n = int(self.meas_n)
        if n == 0:
            return self
        vals = self.thresh - self.meas_val[:n]
        vals = torch.tanh(torch.where(vals > 0, vals / self.thresh,
                                      vals / (self.clip - self.thresh)))
        std = max(self.scale / 2.0, 1e-6)
        diff = self.grid[:, None, :] - self.meas_loc[None, :n, :]
        pdf = torch.exp(-0.5 * (diff ** 2 / std).sum(-1))  # (G, n)
        meas_map = renormalize(pdf, dim=0)
        meas = vals / 2.0 + 0.5
        nf = float(n)
        meas_var = renormalize(meas_map.sum(1) / nf)
        meas_var = _rescale(meas_var, (0.0, 1.0), (50.0 * self.scale, self.scale))
        post_var = 1.0 / (1.0 / self.prior_var + nf / meas_var)
        post = post_var * (self.prior / self.prior_var + meas.sum() / meas_var)
        return dataclasses.replace(self, prior=post, prior_var=post_var,
                                   count=self.count + n, meas_n=torch.zeros_like(self.meas_n))

    def pdf(self, samples):
        """The belief at ``samples`` (N, d) by multilinear interpolation on
        the grid."""
        d, ns = self.grid.shape[1], self.num_samples
        lo, hi = self.lims[:, 0], self.lims[:, 1]
        fc = ((samples - lo) / (hi - lo) * (ns - 1)).clamp(0.0, ns - 1.001)
        base = torch.floor(fc).long()
        frac = fc - base
        vol = self.prior.reshape((ns,) * d)
        if d >= 2:  # the mesh's 'xy' indexing swaps the first two axes
            vol = vol.permute(1, 0, *range(2, d))
        out = 0.0
        for off in itertools.product((0, 1), repeat=d):
            idx = tuple((base[:, k] + off[k]).clamp(0, ns - 1) for k in range(d))
            w = torch.stack([frac[:, k] if off[k] else 1 - frac[:, k] for k in range(d)]).prod(0)
            out = out + vol[idx] * w
        return out

    def entropy(self):
        """The entropy of the grid over its excess mass above the minimum
        plus a floor of a thousandth of the maximum: a flat belief scores
        log(G), whatever its offset."""
        p = self.prior - self.prior.min()
        p = p + 1e-3 * p.max() + 1e-9
        p = p / p.sum()
        return -(p * torch.log(p)).sum()

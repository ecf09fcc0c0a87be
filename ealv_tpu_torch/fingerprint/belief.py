"""Bayesian belief grids for object re-localization (port of
``ealv_tpu/fingerprint/belief.py``): a num_samples^d grid over the widened
exploration box, a ring of pending (pose, distance) measurements, and a
precision-weighted Gaussian fusion of them into the grid's prior.

A belief is a value: ``push``, ``push_batch``, ``update_prior`` and
``push_and_fuse`` return new objects and never write into the old ones, so
a caller can keep the old belief beside the new one. The ring's counters
are device tensors, so no operation waits on the device.

The fusion routes by device: beliefs on CUDA go through the kernel of
``ops/belief.py`` (``csrc/belief.cu``), which reads the pending columns
alone and fuses a whole list of beliefs, pushes included, in three
launches; CPU beliefs take the plain torch version here (``push``, then
``_update_prior_plain``), the kernel's test oracle.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..ops import renormalize
from ..ops.belief import fuse_beliefs


def _rescale(x, old, new):
    return (x - old[0]) / (old[1] - old[0]) * (new[1] - new[0]) + new[0]


@dataclasses.dataclass
class FingerprintBelief:
    grid: torch.Tensor  # (G, d) flattened mesh
    lims: torch.Tensor  # (d, 2) widened limits
    prior: torch.Tensor  # (G,)
    prior_var: torch.Tensor  # (G,)
    meas_loc: torch.Tensor  # (cap, d) pending measurement ring
    meas_val: torch.Tensor  # (cap,)
    meas_n: torch.Tensor  # () int64 pending count
    count: torch.Tensor  # () int64 fused measurements so far
    num_samples: tuple
    scale: float
    thresh: float
    clip: float
    invert: bool = False

    @classmethod
    def create(cls, explr_states: str, lims, num_samples: int = 50,
               meas_capacity: int = 64, scale=None, thresh=1.0, clip=2.0,
               invert: bool = False, device="cuda"):
        """The yaw limits widen 1.33x, then all of them 1.15x; the grid is
        ``np.meshgrid``'s ('xy' indexing) over num_samples points a
        dimension; the default kernel scale is 2.5 times the widest mesh
        spacing. The plain ``update_prior`` holds a (G, meas_capacity, d) footprint,
        so grids over 96 Mi (G, cap) elements are refused."""
        lims = np.asarray(lims, np.float64).copy()
        if "w" in explr_states:
            lims[explr_states.rfind("w")] *= 1.33
        lims = lims * 1.15
        d = lims.shape[0]
        cells = num_samples ** d
        budget = 96 * 1024 * 1024
        if cells * meas_capacity > budget:
            fit = int((budget / meas_capacity) ** (1.0 / d))
            raise ValueError(
                f"belief grid too large: {num_samples}^{d} cells x "
                f"meas_capacity={meas_capacity} = {cells * meas_capacity:.2e} "
                f"elements in update_prior's footprint (budget {budget:.2e}). "
                f"Use num_samples<={fit} at d={d}, reduce meas_capacity, or "
                f"drop angle dims from explr_states and recover them via "
                f"marginalize_angles (the reference's WeightedAvg path).")
        axes = [np.linspace(lo, hi, num_samples) for lo, hi in lims]
        grid = np.stack([m.ravel() for m in np.meshgrid(*axes)], axis=1)
        if scale is None:
            scale = float(np.max([a[1] - a[0] for a in axes]) * 2.5)
        g = grid.shape[0]
        f32 = dict(dtype=torch.float32, device=device)
        zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
        return cls(grid=torch.tensor(grid, **f32), lims=torch.tensor(lims, **f32),
                   prior=torch.full((g,), 0.5, **f32), prior_var=torch.full((g,), 2.0, **f32),
                   meas_loc=torch.zeros((meas_capacity, d), **f32),
                   meas_val=torch.zeros(meas_capacity, **f32), meas_n=zero(), count=zero(),
                   num_samples=(num_samples,) * d, scale=scale, thresh=thresh, clip=clip,
                   invert=invert)

    @property
    def capacity(self) -> int:
        return self.meas_loc.shape[0]

    def push(self, state, val) -> "FingerprintBelief":
        """Add one pending measurement at the ring's next slot."""
        cap = self.capacity
        slot = torch.arange(cap, device=self.meas_loc.device) == self.meas_n % cap
        return dataclasses.replace(
            self, meas_loc=torch.where(slot[:, None], state, self.meas_loc),
            meas_val=torch.where(slot, val, self.meas_val),
            meas_n=(self.meas_n + 1).clamp(max=cap))

    def push_batch(self, states, vals) -> "FingerprintBelief":
        b = self
        for s, v in zip(states, vals):
            b = b.push(s, v)
        return b

    def _process_meas(self, vals):
        """tanh squashing around the distance threshold."""
        tmp = self.thresh - vals
        tmp = torch.where(tmp > 0, tmp / self.thresh, tmp / (self.clip - self.thresh))
        return torch.tanh(tmp)

    def update_prior(self) -> "FingerprintBelief":
        """Precision-weighted Gaussian fusion of the pending measurements
        into the prior; the ring is emptied. No change without pending
        measurements. On CUDA through the kernel (``push_and_fuse``)."""
        if self.prior.is_cuda:
            return push_and_fuse([self])[0]
        return self._update_prior_plain()

    def _update_prior_plain(self) -> "FingerprintBelief":
        """``update_prior`` in torch over every ring column, the pending ones
        masked in: the CPU path and the kernel's oracle."""
        n = self.meas_n
        has = n > 0
        mask = torch.arange(self.capacity, device=n.device) < n
        vals = self._process_meas(self.meas_val)

        # the measurements' Gaussian footprints over the grid
        std = max(self.scale / 2.0, 1e-6)
        diff = self.grid[:, None, :] - self.meas_loc[None, :, :]  # (G, cap, d)
        pdf = torch.exp(-0.5 * (diff ** 2 / std).sum(-1))  # (G, cap)
        meas_map = renormalize(torch.where(mask[None, :], pdf, torch.ones_like(pdf)), dim=0)
        meas_map = torch.where(mask[None, :], meas_map, torch.zeros_like(meas_map))

        meas = vals / 2.0 + 0.5
        nf = n.float().clamp(min=1.0)
        meas_var = renormalize(meas_map.sum(1) / nf)
        meas_var = _rescale(meas_var, (0.0, 1.0), (50.0 * self.scale, self.scale))

        post_var = 1.0 / (1.0 / self.prior_var + nf / meas_var)
        post = post_var * (self.prior / self.prior_var
                           + torch.where(mask, meas, torch.zeros_like(meas)).sum() / meas_var)
        return dataclasses.replace(
            self, prior=torch.where(has, post, self.prior),
            prior_var=torch.where(has, post_var, self.prior_var),
            count=self.count + n, meas_n=torch.zeros_like(n))

    def pdf_grid(self, override_invert: bool = False):
        """The belief over its own grid."""
        dist = self.prior
        if self.invert and not override_invert:
            dist = -dist + dist.max() + dist.min()
        return dist

    def pdf(self, samples, override_invert: bool = False):
        """The belief at arbitrary points by multilinear interpolation on the
        grid."""
        d = self.grid.shape[1]
        ns = self.num_samples[0]
        lo, hi = self.lims[:, 0], self.lims[:, 1]
        fc = ((samples - lo) / (hi - lo) * (ns - 1)).clamp(0.0, ns - 1.001)
        base = torch.floor(fc).long()  # (N, d)
        frac = fc - base
        vol = self.prior.reshape(self.num_samples)
        if d >= 2:  # the mesh's 'xy' indexing swaps the first two axes
            vol = vol.permute(1, 0, *range(2, d))
        out = 0.0
        for off in itertools.product((0, 1), repeat=d):
            idx = tuple((base[:, k] + off[k]).clamp(0, ns - 1) for k in range(d))
            w = torch.stack([frac[:, k] if off[k] else 1 - frac[:, k] for k in range(d)]).prod(0)
            out = out + vol[idx] * w
        if self.invert and not override_invert:
            out = -out + self.prior.max() + self.prior.min()
        return out


def push_and_fuse(beliefs, pushes=None) -> list:
    """Each belief's pushes (rows (P, d) with values (P,), or None) pushed in
    order, then its pending measurements fused (``push`` for each row, then
    ``update_prior``). CUDA beliefs, all of one grid and ring, take one
    kernel call for the whole list (``ops.belief.fuse_beliefs``: three
    launches for every 16 beliefs), CPU beliefs the plain methods. Returns
    the new beliefs."""
    pushes = [None] * len(beliefs) if pushes is None else list(pushes)
    if beliefs and beliefs[0].prior.is_cuda:
        return [dataclasses.replace(b, **new)
                for b, new in zip(beliefs, fuse_beliefs(beliefs, pushes))]
    out = []
    for b, push in zip(beliefs, pushes):
        if push is not None:
            b = b.push_batch(*push)
        out.append(b._update_prior_plain())
    return out


def marginalize_angles(p_grid, num_samples, plot_idx, method: str = "mean"):
    """Collapse the grid's dims outside ``plot_idx``: mean, max, range, or
    the sorted geometric-weight averages 'WeightedAvg1' (weights favour the
    max end) and 'WeightedAvg2' (the min end). p_grid (G,) -> the grid over
    plot_idx."""
    p = p_grid.reshape(num_samples)
    extra = tuple(i for i in range(len(num_samples)) if i not in tuple(plot_idx))
    if not extra:
        return p
    if method == "mean":
        return p.mean(extra)
    if method == "max":
        return p.amax(extra)
    if method == "range":
        return p.amax(extra) - p.amin(extra)
    if method.startswith("WeightedAvg"):
        out = p
        for axis in sorted(extra, reverse=True):
            srt = torch.sort(out, dim=axis).values
            n = out.shape[axis]
            k = torch.arange(n, dtype=torch.float32, device=p.device)
            w = 0.95 ** (n - k) if "1" in method else 0.95 ** k
            shape = [1] * out.ndim
            shape[axis] = n
            out = (srt * w.reshape(shape)).sum(axis) / w.sum()
        return out
    raise ValueError(f"invalid angle method {method!r}")

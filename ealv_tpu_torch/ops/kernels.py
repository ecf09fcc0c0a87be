"""Ergodic-control kernels in torch (port of ``ealv_tpu/ops/kernels.py``).

``traj_footprint`` and ``traj_spread`` go through K1
(``ops/footprint.py``): the CUDA kernel for every CUDA float32 call, at
every size, and the plain torch version for CPU tensors. The rest was XLA
code in the JAX package and stays plain torch in float32. Squared
distances are taken from direct per-dimension differences, never the
|a|^2 + |b|^2 - 2ab expansion, whose cancellation error exp() amplifies.
"""

from __future__ import annotations

import torch

from .footprint import footprint_and_spread


def psi_matrix(samples, traj, std, traj_mask=None):
    """psi[n, t] = exp(-0.5 * sum_d (s_nd - x_td)^2 / |std_d|), (N, T) f32;
    ``traj_mask`` (T,) zeroes invalid ring rows."""
    sq = ((samples[:, None, :] - traj[None, :, :]) ** 2 / std.abs()).sum(-1)
    psi = torch.exp(-0.5 * sq)
    if traj_mask is not None:
        psi = psi * traj_mask[None, :]
    return psi


def _footprint_spread(traj, samples, explr_idx, std, traj_mask):
    traj_explr = traj[:, explr_idx].contiguous()
    if traj_mask is None:
        traj_mask = torch.ones(traj.shape[0], device=traj.device)
    return footprint_and_spread(samples.contiguous(), traj_explr,
                                std.contiguous(),
                                traj_mask.to(torch.float32).contiguous())


def traj_footprint(traj, samples, explr_idx, std, nu=1.0, traj_mask=None):
    """q(s) = sum_t psi(s, x_t) / nu over the exploration columns
    ``explr_idx`` of the full-state trajectory rows."""
    fsum, _ = _footprint_spread(traj, samples, explr_idx, std, traj_mask)
    return fsum / nu


def traj_spread(traj, samples, explr_idx, std, nu=1.0, traj_mask=None):
    """max_t psi(s, x_t) / nu (coverage); masked rows count as unvisited."""
    _, fmax = _footprint_spread(traj, samples, explr_idx, std, traj_mask)
    return fmax / nu


def kldiv_grad_batch(xs, samples, explr_idx, std, importance_ratio, nu=1.0):
    """Importance-weighted footprint gradient at every trajectory state:
    g[t, d] = sum_n w_n * -(x_td - s_nd)/|std_d| * psi(x_t, s_n), scattered
    into the full state at ``explr_idx``. (T, n_states) -> (T, n_states)."""
    xs_e = xs[:, explr_idx]
    std_a = std.abs()
    diff = -(xs_e[:, None, :] - samples[None, :, :]) / std_a  # (T, N, d)
    w = psi_matrix(xs_e, samples, std) * importance_ratio[None, :] / nu
    g = torch.einsum("tnd,tn->td", diff, w)
    out = torch.zeros_like(xs)
    out[:, explr_idx] = g
    return out


def cost_norm(dist):
    """Nan-safe sum-normalization."""
    dist = torch.where(torch.isnan(dist), torch.full_like(dist, 1e-6), dist)
    return dist / dist.sum()


def renormalize(dist, dim=None, min_val: float = 1e-6):
    """normalize -> clamp -> log -> subtract max -> exp; the output max is 1.
    ``dim=None`` works over the whole tensor."""
    if dim is None:
        dist = dist / dist.sum()
        logd = torch.log(dist.clamp(min=min_val))
        return torch.exp(logd - logd.max())
    dist = dist / dist.sum(dim, keepdim=True)
    logd = torch.log(dist.clamp(min=min_val))
    return torch.exp(logd - logd.amax(dim, keepdim=True))

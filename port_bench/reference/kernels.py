"""The planner's footprint arithmetic in plain torch: a frozen copy of
``ealv_tpu_torch/ops/kernels.py`` with K1 (the footprint and spread
reduction) replaced by its plain sums and maxes, in float32.

Each pair's term is taken as the configuration's K1 takes it, so that the
coverage spread, a max, comes out in the same bits: both sides whitened
by rsqrt(|std|) * sqrt(0.5 * log2(e)), per-dimension differences, their
squares summed in dimension order with one rounding a step (a fused
multiply-add, emulated in float64) and exp2 of the negated sum. The
spread's mean weighs the trainer's cross-decode term, where a last-place
difference grows over the call's Adam steps. The footprint's sum over the
points is taken in torch's order."""

from __future__ import annotations

import torch

WHITEN = 0.84932180028801904272  # sqrt(0.5 * log2(e)): exp(-0.5 q) = exp2(-q * 0.5 * log2(e))


def pair_terms(samples, traj, std, traj_mask):
    """psi[n, t] = m_t exp(-0.5 |s_n - x_t|^2) after whitening both sides
    by rsqrt(|std|), (N, T) f32."""
    w = torch.rsqrt(std.abs()) * torch.tensor(WHITEN, dtype=torch.float32, device=std.device)
    diff = (samples * w)[:, None, :] - (traj * w)[None, :, :]
    sq = torch.zeros(diff.shape[:2], dtype=torch.float32, device=diff.device)
    for k in range(diff.shape[-1]):
        d = diff[..., k].double()
        sq = (d * d + sq.double()).float()
    return torch.exp2(-sq) * traj_mask[None, :]


def footprint_and_spread(samples, traj, std, traj_mask):
    """(sum_t psi, max_t psi) of ``pair_terms``."""
    psi = pair_terms(samples, traj, std, traj_mask)
    return psi.sum(1), psi.amax(1)


def psi_matrix(samples, traj, std, traj_mask=None):
    """psi[n, t] = exp(-0.5 * sum_d (s_nd - x_td)^2 / |std_d|), (N, T) f32;
    ``traj_mask`` (T,) zeroes invalid ring rows."""
    sq = ((samples[:, None, :] - traj[None, :, :]) ** 2 / std.abs()).sum(-1)
    psi = torch.exp(-0.5 * sq)
    if traj_mask is not None:
        psi = psi * traj_mask[None, :]
    return psi


def _footprint_spread(traj, samples, explr_idx, std, traj_mask):
    if traj_mask is None:
        traj_mask = torch.ones(traj.shape[0], device=traj.device)
    return footprint_and_spread(samples, traj[:, explr_idx], std,
                                traj_mask.to(torch.float32))


def traj_footprint(traj, samples, explr_idx, std, nu=1.0, traj_mask=None):
    """q(s) = sum_t psi(s, x_t) / nu over the exploration columns."""
    fsum, _ = _footprint_spread(traj, samples, explr_idx, std, traj_mask)
    return fsum / nu


def traj_spread(traj, samples, explr_idx, std, nu=1.0, traj_mask=None):
    """max_t psi(s, x_t) / nu (coverage); masked rows count as unvisited."""
    _, fmax = _footprint_spread(traj, samples, explr_idx, std, traj_mask)
    return fmax / nu


def kldiv_grad_batch(xs, samples, explr_idx, std, importance_ratio, nu=1.0):
    """Importance-weighted footprint gradient at every trajectory state,
    scattered into the full state at ``explr_idx``."""
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
    """normalize -> clamp -> log -> subtract max -> exp; the output max is 1."""
    if dim is None:
        dist = dist / dist.sum()
        logd = torch.log(dist.clamp(min=min_val))
        return torch.exp(logd - logd.max())
    dist = dist / dist.sum(dim, keepdim=True)
    logd = torch.log(dist.clamp(min=min_val))
    return torch.exp(logd - logd.amax(dim, keepdim=True))

"""Hyperparameter (beta/gamma) schedules (port of
``ealv_tpu/runtime/schedules.py``): entropy-based grade and spread, fixed
values and manual ramps."""

from __future__ import annotations

import dataclasses

import torch

from ..ops import traj_spread


@dataclasses.dataclass
class HyperState:
    beta: torch.Tensor  # ()
    gamma: torch.Tensor  # ()
    iter: int = 0  # total optimizer iterations

    @classmethod
    def create(cls, device, beta0: float = 0.0, gamma0: float = 0.0):
        return cls(beta=torch.tensor(beta0, device=device),
                   gamma=torch.tensor(gamma0, device=device))


def entropy_grade(pdf_vals, spread, xi: float = 4.0):
    """Clamped inverse min normalized entropy with exponent xi."""
    ent = pdf_vals ** spread
    ent = ent / ent.max().clamp(min=1e-30)
    return torch.pow(10.0, -torch.log10(ent.min().clamp(min=1e-30)) - xi).clamp(max=0.01)


def entropy_grade_spread(pdf_vals, all_x, x_mask, samples, explr_idx, std,
                         xi: float = 4.0):
    """(grade, spread) from the model pdf at ``samples`` and the coverage of
    the visited poses ``all_x`` with validity mask ``x_mask``."""
    max_q = traj_spread(all_x, samples, explr_idx, std, traj_mask=x_mask)
    max_q = max_q / max_q.max().clamp(min=1e-30)
    spread = torch.where(x_mask.sum() > 0, max_q.mean(), torch.zeros_like(max_q[0]))
    return entropy_grade(pdf_vals, spread, xi), spread


def hyperparam_update(hs: HyperState, grade, spread, *, fixed_beta=False,
                      beta_manual_ramp=False, fixed_gamma=False,
                      gamma_manual_ramp=False, other_locs=True, beta_start=0.0,
                      beta_end=0.05, beta_warmup_steps=1000, beta_warmup_epoch=10,
                      gamma_start=0.0, gamma_end=1.0, gamma_warmup_steps=1000,
                      gamma_warmup_epoch=10) -> HyperState:
    """Select beta/gamma for the next trainer call."""
    dev = hs.beta.device
    const = lambda v: torch.tensor(float(v), device=dev)
    if fixed_beta:
        beta = const(beta_start)
    elif not beta_manual_ramp:  # entropy-based (default)
        beta = grade.float()
    else:
        d_beta = (beta_end - beta_start) / max(beta_warmup_steps, 1)
        ramp = min(hs.iter // max(beta_warmup_epoch, 1), beta_warmup_steps)
        beta = const(beta_start + d_beta * ramp)
    if fixed_gamma or not other_locs:
        gamma = const(gamma_start if fixed_gamma else 0.0)
    elif not gamma_manual_ramp:  # entropy-based (default)
        gamma = spread.float()
    else:
        d_gamma = (gamma_end - gamma_start) / max(gamma_warmup_steps, 1)
        ramp = min(hs.iter // max(gamma_warmup_epoch, 1), gamma_warmup_steps)
        gamma = const(gamma_start + d_gamma * ramp)
    return dataclasses.replace(hs, beta=beta, gamma=gamma)

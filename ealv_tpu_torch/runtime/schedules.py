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


def manual_ramp(it: int, start: float, end: float, warmup_steps: int,
                warmup_epoch: int) -> float:
    """A manual ramp's value after ``it`` optimizer iterations: from
    ``start`` to ``end`` in ``warmup_steps`` steps of ``warmup_epoch``
    iterations each."""
    d = (end - start) / max(warmup_steps, 1)
    return start + d * min(it // max(warmup_epoch, 1), warmup_steps)


def hyperparam_update(hs: HyperState, grade, spread, *, fixed_beta=False,
                      beta_manual_ramp=False, fixed_gamma=False,
                      gamma_manual_ramp=False, other_locs=True, beta_start=0.0,
                      beta_end=0.05, beta_warmup_steps=1000, beta_warmup_epoch=10,
                      gamma_start=0.0, gamma_end=1.0, gamma_warmup_steps=1000,
                      gamma_warmup_epoch=10, ramp=None) -> HyperState:
    """Select beta/gamma for the next trainer call. ``ramp`` holds the
    manual ramps' (beta, gamma) as () device tensors, staged by a captured
    step in place of the values computed from ``hs.iter`` (a host int,
    which a capture would freeze)."""
    dev = hs.beta.device
    # a fill, not a copy from host memory: nothing waits, and a capture can
    # record it
    const = lambda v: torch.full((), float(v), device=dev)
    if fixed_beta:
        beta = const(beta_start)
    elif not beta_manual_ramp:  # entropy-based (default)
        beta = grade.float()
    elif ramp is not None:
        beta = ramp[0].clone()
    else:
        beta = const(manual_ramp(hs.iter, beta_start, beta_end, beta_warmup_steps,
                                 beta_warmup_epoch))
    if fixed_gamma or not other_locs:
        gamma = const(gamma_start if fixed_gamma else 0.0)
    elif not gamma_manual_ramp:  # entropy-based (default)
        gamma = spread.float()
    elif ramp is not None:
        gamma = ramp[1].clone()
    else:
        gamma = const(manual_ramp(hs.iter, gamma_start, gamma_end, gamma_warmup_steps,
                                  gamma_warmup_epoch))
    return dataclasses.replace(hs, beta=beta, gamma=gamma)

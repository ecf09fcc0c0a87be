"""The planner's horizon recurrences: the rollout of plans through the
dynamics model and the costate's backward RK4 sweep.

``rollout`` and ``costate`` serve ``control/klerg.py`` (``_traj_states``,
``_rollout``, ``_forward``, ``_backward``). On CUDA tensors each call is
one launch of a hand-written kernel (``ops/rollout.py``), whose model and
policy arguments each dynamics model and warm-start policy gives as
``rollout_args()``; on CPU tensors they run ``horizon_rollout_reference``
and ``costate_sweep_reference``, the per-step loops with the operations
the planner always ran (so the CPU keeps its bits), which are also the
kernels' oracles. An input the kernel does not take (not float32, not
contiguous, out of its sizes, a model or policy without ``rollout_args``)
raises on either device. There is no fallback from a kernel to the plain
version.
"""

from __future__ import annotations

import math

import torch

from ..ops import rollout as kernels
from .dynamics import DynState, rk4_step


def horizon_rollout_reference(dyn, policy, x0, R0, u):
    """Roll plans ``u`` (..., H, m) out from the state (x0 (n,), R0 (3, 3))
    with ``dyn.step``, applying ``policy.act`` at each pre-step state
    (``policy`` None applies the plans as they are). Returns the states
    (..., H + 1, n) x_0..x_H, the rotations (..., H + 1, 3, 3) and the
    applied controls (..., H, m)."""
    batch = u.shape[:-2]
    s = DynState(x=x0.expand(*batch, *x0.shape), R=R0.expand(*batch, *R0.shape))
    xs, Rs, us = [s.x], [s.R], []
    for t in range(u.shape[-2]):
        ut = u[..., t, :] if policy is None else policy.act(s.x, u[..., t, :])
        us.append(ut)
        s = dyn.step(s, ut)
        xs.append(s.x)
        Rs.append(s.R)
    return torch.stack(xs, -2), torch.stack(Rs, -3), torch.stack(us, -2)


def costate_sweep_reference(drive, jac, dt: float):
    """rho' = drive[t] - jac[t]^T rho, integrated with RK4 at step -dt from
    rho = 0 over t = H - 1 down to 0. drive (H, n), jac (H, n, n); returns
    rhos (H, n), rhos[t] the costate after step t."""
    M = jac.transpose(-1, -2)
    rho = torch.zeros(drive.shape[-1], device=drive.device)
    rhos = [None] * drive.shape[0]
    for t in reversed(range(drive.shape[0])):
        rho = rk4_step(lambda r, _: drive[t] - M[t] @ r, -dt, rho, None)
        rhos[t] = rho
    return torch.stack(rhos)


def _args(dyn, policy) -> dict:
    for what, obj in (("dynamics model", dyn), ("policy", policy)):
        if obj is not None and not hasattr(obj, "rollout_args"):
            raise TypeError(f"the rollout kernel has no code for the {what} "
                            f"{type(obj).__name__}")
    return {**dyn.rollout_args(), **({} if policy is None else policy.rollout_args())}


def rollout(dyn, policy, x0, R0, u):
    """Plans ``u`` (..., H, m) rolled out from (x0 (n,), R0 (3, 3)) through
    ``dyn``, with ``policy.act`` at each step (None: the plans as they
    are). Returns (states (..., H + 1, n), rotations (..., H + 1, 3, 3),
    applied controls (..., H, m)): one kernel launch for all the plans on
    CUDA tensors, ``horizon_rollout_reference`` on CPU tensors."""
    args = _args(dyn, policy)
    if u.device.type == "cpu":
        kernels.check_rollout(x0, R0, u, **args)
        return horizon_rollout_reference(dyn, policy, x0, R0, u)
    return kernels.horizon_rollout(x0, R0, u, **args)


def costate(drive, jac, dt: float):
    """The costate rhos (H, n) of rho' = drive[t] - jac[t]^T rho (drive (H,
    n), jac (H, n, n)), RK4 at step -dt backwards from rho = 0: one kernel
    launch on CUDA tensors, ``costate_sweep_reference`` on CPU tensors."""
    if drive.device.type == "cpu":
        kernels.check_costate(drive, jac)
        return costate_sweep_reference(drive, jac, dt)
    return kernels.costate_sweep(drive, jac, dt)


def state_gap(got, want, angles=()) -> float:
    """max |got - want| / max(|want|, 1), the ``angles`` columns taken
    around the circle (a state by a wrap cut may land on either side): how
    far a kernel's states lie from the plain version's."""
    d = got - want
    if angles:
        rows = list(angles)
        d[..., rows] = torch.remainder(d[..., rows] + math.pi, 2 * math.pi) - math.pi
    return float((d.abs() / want.abs().clamp(min=1.0)).max())

"""The planner's inner iteration: the slot where the cost falls fastest and
the candidate windows, the window search's acceptance, the step's
acceptance, and the cost those read.

``choose_slot``, ``accept_window``, ``accept_step`` and ``plan_cost`` serve
``control/klerg.py``'s inner loop. On CUDA tensors each call is one launch
of a hand-written kernel (``ops/descent.py``); on CPU tensors they run
``choose_slot_reference``, ``accept_window_reference``,
``accept_step_reference`` and ``plan_cost_reference``, the torch
operations the planner always ran (the JAX package's ``_line_search``,
inner loop and ``_cost``, ``ealv_tpu/control/klerg.py``), which are also
the kernels' oracles. The first three do integer arithmetic, comparisons,
``where``, ``gather`` and ``argmin`` alone, so their kernels give the same
bits. The cost's kernel sums in another order, and gives a single plan's
footprint K1's bits; its costs only decide (the slot's windows, the
acceptances), so a plan's outputs keep their bits unless a decision sits
on a near-tie. An input the kernels do not take raises on either device;
there is no fallback from a kernel to the plain version.
"""

from __future__ import annotations

import torch

from ..ops import descent as kernels
from ..ops.descent import Slot
from ..ops.kernels import cost_norm, psi_matrix, renormalize, traj_footprint
from .barrier import BarrierFunction, NoBarrier


def choose_slot_reference(djdlam, u, u_eff, u_star, idx: int, max_app_dur=None,
                          lam=None) -> Slot:
    """The slot t_app = argmin(djdlam) (H,), its control u_app = u_star[t_app]
    and step_done: a djdlam at t_app that is not negative stops the loop.
    With ``lam`` (a fixed window) the new plan u_eff with u_app over
    [t_app, t_app + lam); with ``max_app_dur`` the line search's first
    window size lam0, its windows [tis, tfs) for lam = 1 .. max_app_dur and
    their candidates, the nominal plan u with u_app over each window."""
    H = djdlam.shape[0]
    dev = djdlam.device
    w = torch.where
    t = torch.arange(H, device=dev)
    t_app = torch.argmin(djdlam)
    u_app = u_star.index_select(0, t_app.reshape(1))[0]
    step_done = ~(djdlam.gather(0, t_app.reshape(1))[0] < 0)
    if lam is not None:
        m = ((t >= t_app) & (t < t_app + lam))[:, None]
        return Slot(t_app.reshape(1), u_app, step_done, w(m, u_app[None], u_eff))
    mad = max_app_dur
    i64 = lambda v: torch.full((), v, dtype=torch.int64, device=dev)
    lam0 = w((t_app == 0) | (t_app == H - 1), i64(min(H, mad)),
             w(t_app == idx, (H - t_app).clamp(max=mad),
               torch.minimum(torch.minimum(t_app - idx, H - t_app - idx),
                             i64((mad + 1) // 2))))
    lam0 = lam0.clamp(min=1)
    lams = torch.arange(1, mad + 1, device=dev)
    tis = w(t_app == idx, t_app.expand(mad), w(t_app == H - 1, lams - 1, t_app - lams))
    tfs = w(t_app == idx, lams + 1, w(t_app == H - 1, t_app.expand(mad), t_app + lams + 1))
    masks = (t[None, :] >= tis[:, None]) & (t[None, :] < tfs[:, None])  # (mad, H)
    u_variants = w(masks[:, :, None], u_app[None, None, :], u[None, :, :])
    ints = torch.cat([t_app.reshape(1), lam0.reshape(1), tis, tfs])
    return Slot(ints, u_app, step_done, u_variants)


def accept_window_reference(Js, J0, slot: Slot, u_eff, idx: int):
    """The line search's sequential early-stopping acceptance as a masked
    loop over the candidates' costs ``Js`` (max_app_dur,), from the window
    lam0 down, against the last cost ``J0``. Returns (ti, tf, ok, u_new):
    the window taken, whether the search succeeded, and u_eff with u_app
    over [ti, tf) if it did (the windows are costed on the nominal plan and
    applied to u_eff)."""
    H = u_eff.shape[0]
    mad = Js.shape[0]
    dev = Js.device
    w = torch.where
    lam0, tis, tfs = slot.lam0, slot.tis, slot.tfs
    i64 = lambda v: torch.full((), v, dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    ti_l, tf_l, Jn_last = i64(idx), lam0, J0 * 2.0
    ti, tf, Jn = i64(idx), lam0, J0 * 2.0
    for k in range(mad):
        lam_k = lam0 - k
        active = ~done & (lam_k > 0)
        sel = (lam_k - 1).clamp(min=0).reshape(1)
        # keep the current window as "last" before testing the next one
        ti_l2 = w(active, ti, ti_l)
        tf_l2 = w(active, tf, tf_l)
        Jn_last2 = w(active, Jn, Jn_last)
        Jn2 = w(active, Js.gather(0, sel)[0], Jn)
        done = done | (active & (Jn_last2 < J0) & (Jn2 > Jn_last2))
        ti_l, tf_l, Jn_last = ti_l2, tf_l2, Jn_last2
        ti = w(active, tis.gather(0, sel)[0], ti)
        tf = w(active, tfs.gather(0, sel)[0], tf)
        Jn = Jn2
    take_cur = ~done & (Jn < J0)
    ti, tf, ok = w(take_cur, ti, ti_l), w(take_cur, tf, tf_l), done | take_cur
    t = torch.arange(H, device=dev)
    m = (ok & (t >= ti) & (t < tf))[:, None]
    return ti, tf, ok, w(m, slot.u_app[None], u_eff)


def accept_step_reference(u_new, cost, q, step_done, u, last_cost, q_keep, done,
                          check_cost: bool):
    """The inner loop's acceptance: the new plan ``u_new`` at ``cost`` with
    its footprint ``q`` is taken unless the loop is ``done``, the slot
    stopped it (``step_done``; None: it did not) or, with ``check_cost``
    (every iteration but the first), the cost did not fall below
    ``last_cost``. Returns (u, last_cost, q_keep, done)."""
    if step_done is None:
        step_done = torch.zeros_like(done)
    cost_break = (last_cost <= cost) if check_cost else torch.zeros_like(done)
    accept = ~done & ~step_done & ~cost_break
    return (torch.where(accept, u_new, u), torch.where(accept, cost, last_cost),
            torch.where(accept, q, q_keep), done | step_done | cost_break)


def plan_cost_reference(trajs, samples, p_n, q_base, std, explr_idx, barrier):
    """KL + barrier cost of a trajectory (H, n) -> (), through K1, or of
    candidates (K, H, n) -> (K,), through one plain psi matrix: the
    footprint of the states' columns ``explr_idx`` (an index tensor on the
    states' device) at the samples added to ``q_base``, renormalised,
    against the target ``p_n``, plus the barrier over the steps."""
    if trajs.ndim == 2:
        q_iter = traj_footprint(trajs, samples, explr_idx, std)
        q = cost_norm(renormalize(q_base + q_iter))
        return (p_n * torch.log(p_n / q)).sum() + barrier.batch(trajs).sum()
    k, h, _ = trajs.shape
    flat = trajs[..., explr_idx].reshape(k * h, -1)
    psi_m = psi_matrix(samples, flat, std)  # (N, K*H)
    q_iters = psi_m.reshape(-1, k, h).sum(-1).T  # (K, N)
    q = renormalize(q_base[None, :] + q_iters, dim=1)
    q = torch.where(torch.isnan(q), torch.full_like(q, 1e-6), q)
    q = q / q.sum(1, keepdim=True)
    d_kl = (p_n[None, :] * torch.log(p_n[None, :] / q)).sum(1)
    return d_kl + barrier.batch(trajs).sum(-1)


def _barrier_rows(barrier):
    """The box barrier's rows as the cost kernel takes them: (b_lim,
    barr_weight, power) of a ``BarrierFunction``, none of ``NoBarrier``,
    and None for another barrier, whose plain ``batch`` is added after."""
    if isinstance(barrier, BarrierFunction):
        return barrier.b_lim, barrier.barr_weight, barrier.power
    if isinstance(barrier, NoBarrier):
        return ()
    return None


def choose_slot(djdlam, u, u_eff, u_star, idx: int, max_app_dur=None, lam=None) -> Slot:
    """``choose_slot_reference``: one kernel launch on CUDA tensors."""
    if djdlam.device.type == "cpu":
        kernels.check_slot(djdlam, u, u_eff, u_star, idx, max_app_dur, lam)
        return choose_slot_reference(djdlam, u, u_eff, u_star, idx, max_app_dur, lam)
    return kernels.descent_slot(djdlam, u, u_eff, u_star, idx, max_app_dur, lam)


def accept_window(Js, J0, slot: Slot, u_eff, idx: int):
    """``accept_window_reference``: one kernel launch on CUDA tensors."""
    if Js.device.type == "cpu":
        kernels.check_window(Js, J0, slot, u_eff, idx)
        return accept_window_reference(Js, J0, slot, u_eff, idx)
    return kernels.descent_window(Js, J0, slot, u_eff, idx)


def accept_step(u_new, cost, q, step_done, u, last_cost, q_keep, done, check_cost: bool):
    """``accept_step_reference``: one kernel launch on CUDA tensors."""
    if u.device.type == "cpu":
        kernels.check_accept(u_new, cost, q, step_done, u, last_cost, q_keep, done)
        return accept_step_reference(u_new, cost, q, step_done, u, last_cost, q_keep, done,
                                     check_cost)
    return kernels.descent_accept(u_new, cost, q, step_done, u, last_cost, q_keep, done,
                                  check_cost)


def plan_cost(trajs, samples, p_n, q_base, std, explr_idx, explr_locs, barrier):
    """``plan_cost_reference``: one kernel launch on CUDA tensors, with the
    plain barrier of a barrier that is neither the box nor none added
    after it. The exploration columns come twice: ``explr_idx`` as an index
    tensor for the plain version, ``explr_locs`` as the same ints for the
    kernel, which takes them by value (no copy from host memory)."""
    rows = _barrier_rows(barrier)
    args = (trajs, samples, p_n, q_base, std, explr_locs, *(rows or ()))
    if trajs.device.type == "cpu":
        kernels.check_cost(*args)
        return plan_cost_reference(trajs, samples, p_n, q_base, std, explr_idx, barrier)
    cost = kernels.plan_cost(*args)
    return cost if rows is not None else cost + barrier.batch(trajs).sum(-1)

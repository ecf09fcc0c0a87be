"""Sample-based KL-ergodic MPC: a frozen copy of the port's planner
(``ealv_tpu_torch/control/klerg.py``), footprints from the plain sums.

The JAX planner is one jitted program whose fixed-trip ``lax.scan``s carry
``done`` masks. Here they are Python loops over the same fixed trip counts
with ``torch.where`` on the masks: no call in a planner call synchronises
with the device (no ``.item()``, ``bool(tensor)``, ``.cpu()`` or tensor
built from Python data; ``chip_smoke.py`` runs ``plan_step`` under
``torch.cuda.set_sync_debug_mode("error")``), and the number of K1 launches
per call is fixed (13 at the default config: the target spread, the base
footprint, the initial cost, and two per inner iteration). The host still
blocks inside a call: its about 7,700 launches at the production config
overrun the card's launch queue (about a thousand), so the host waits for
room while the device catches up. ``full_cost`` costs its H one-slot
substitutions as one batch through the plain psi matrix, as the line
search costs its windows, so it adds no K1 launch. Models whose linearization depends on the state
(``dyn.state_dependent``) are linearized at every step of the horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .kernels import (
    renormalize,
    cost_norm,
    traj_footprint,
    traj_spread,
    kldiv_grad_batch,
    psi_matrix,
)
from .replay import TrajMemory
from .dynamics import rk4_step, DynState
from .policies import BarrierPushPolicy, RollPolicy, ZeroPolicy


@dataclasses.dataclass(frozen=True)
class KlergConfig:
    """Static planner configuration."""

    horizon: int = 10
    num_target_samples: int = 2000
    num_traj_samples: int = 3000
    dt: float = 0.1
    R: float = 0.5
    std: float = 0.05
    alpha: float = 1.0
    pct_inner: float = 0.5  # share of the horizon run as inner iterations
    ctrl_app_search: bool = True
    full_cost: bool = False
    fixed_lam: bool = False
    lam: int = 1
    saturate: bool = False
    max_app_dur: int = 5
    weight_temp: bool = True
    weight_env: bool = False
    uniform_tdist: bool = False
    add_recent_history: bool = False
    sample_near_current_loc: bool = False
    vel_smoothing: float = 0.8

    @property
    def num_iters(self) -> int:
        return max(1, int(self.pct_inner * self.horizon))


@dataclasses.dataclass
class PlannerState:
    u: torch.Tensor  # (H, m) control plan
    dyn: DynState  # current (measured) robot state
    memory: TrajMemory  # visited-state ring
    lims: torch.Tensor  # (d_explr, 2) sampling limits
    barrier: object  # BarrierFunction
    last_plan: torch.Tensor  # (H+1, n) forward-simulated plan
    gen: torch.Generator  # the planner's own random stream


class KlergPlanner:
    """Binds the static config, dynamics, policy and target ``pdf_fn(ctx,
    samples)``. ``explr_locs`` are the explored state indices; ``states``
    is the exploration state string (per-dim kernel widths)."""

    def __init__(self, cfg: KlergConfig, dyn, policy, pdf_fn: Callable,
                 states: str, explr_locs, prior_dist=None, device="cuda"):
        self.cfg = cfg
        self.dyn = dyn
        self.policy = policy
        self.pdf_fn = pdf_fn
        self.device = device
        # the scene prior (``use_prior``) is not copied: no cell plans on it
        self.prior_dist = prior_dist
        self.states = states
        self.explr_locs = list(explr_locs)
        # index with a device tensor: a Python list index is copied to the
        # card from pageable memory, and that copy waits for the device
        self._explr_idx = torch.tensor(self.explr_locs, device=device)
        # velocities (upper case) get a 5x kernel width
        self.std = torch.tensor([1.0 if s == s.lower() else 5.0 for s in states],
                                device=device) * cfg.std
        m = dyn.num_actions
        ctrl_states = states[:m] if len(states) >= m else states
        self.control_lim = torch.tensor(
            [[-0.5, 0.5] if s == "z" else [-1.0, 1.0] for s in ctrl_states.ljust(m, "x")],
            device=device)
        self.R_inv = torch.linalg.inv(torch.eye(m, device=device) * cfg.R)
        self._robot_lim = None

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _traj_states(self, dyn0: DynState, u):
        """(..., H, n) post-step states of plan(s) u (..., H, m); the whole
        state, R included, is carried through the steps."""
        batch = u.shape[:-2]
        s = DynState(x=dyn0.x.expand(*batch, *dyn0.x.shape),
                     R=dyn0.R.expand(*batch, *dyn0.R.shape))
        xs = []
        for t in range(u.shape[-2]):
            s = self.dyn.step(s, u[..., t, :])
            xs.append(s.x)
        return torch.stack(xs, -2)

    def _rollout(self, dyn0: DynState, u):
        """(H+1, n) states from rolling u open loop, start included."""
        return torch.cat([dyn0.x[None], self._traj_states(dyn0, u)], 0)

    def _cost(self, dyn0, u_test, samples, p_n, q_base, barrier):
        """KL + barrier cost of a plan (H, m) -> (), or of candidates
        (K, H, m) -> (K,) through one plain psi matrix."""
        if u_test.ndim == 2:
            traj = self._traj_states(dyn0, u_test)
            q_iter = traj_footprint(traj, samples, self._explr_idx, self.std)
            q = cost_norm(renormalize(q_base + q_iter))
            return (p_n * torch.log(p_n / q)).sum() + barrier.batch(traj).sum()
        trajs = self._traj_states(dyn0, u_test)  # (K, H, n)
        k, h, _ = trajs.shape
        flat = trajs.reshape(k * h, -1)[:, self._explr_idx]
        psi_m = psi_matrix(samples, flat, self.std)  # (N, K*H)
        q_iters = psi_m.reshape(-1, k, h).sum(-1).T  # (K, N)
        q = renormalize(q_base[None, :] + q_iters, dim=1)
        q = torch.where(torch.isnan(q), torch.full_like(q, 1e-6), q)
        q = q / q.sum(1, keepdim=True)
        d_kl = (p_n[None, :] * torch.log(p_n[None, :] / q)).sum(1)
        return d_kl + barrier.batch(trajs).sum(-1)

    def _forward(self, pstate: PlannerState, u, idx: int):
        """Forward pass collecting linearizations at the pre-step states.
        Returns (u_eff (H, m), pre-step states (H, n), A (H, n, n),
        B (H, n, m), dbarr (H, n), dmu (H, m, n)). BarrierPush ignores the
        nominal controls on the first iteration."""
        if idx == 0 and isinstance(self.policy, BarrierPushPolicy):
            u = torch.zeros_like(u)
        s = pstate.dyn
        u_eff, xs, Rs = [], [], []
        for t in range(u.shape[0]):
            ut = self.policy.act(s.x, u[t])
            u_eff.append(ut)
            xs.append(s.x)
            Rs.append(s.R)
            s = self.dyn.step(s, ut)
        u_eff, xs = torch.stack(u_eff), torch.stack(xs)
        H, n = xs.shape
        if self.dyn.state_dependent:
            A, B = self.dyn.get_lin(DynState(x=xs, R=torch.stack(Rs)), u_eff)
        else:
            A, B = self.dyn.get_lin(pstate.dyn, None)
        A = A.expand(H, n, n)
        B = B.expand(H, n, self.dyn.num_actions)
        return (u_eff, xs, A, B, pstate.barrier.dbarr(xs),
                self.policy.dx(xs, u_eff))

    def _backward(self, samples, p, q, xs, A, B, dbarr, dmu):
        """Costate integration backwards over the horizon. Returns
        (du (H, m), djdlam (H,))."""
        dgdx = kldiv_grad_batch(xs, samples, self._explr_idx, self.std, p / q)
        M = (A + B @ dmu).transpose(-1, -2)  # (H, n, n)
        drive = dgdx - dbarr
        rho = torch.zeros(self.dyn.num_states, device=xs.device)
        rhos = [None] * xs.shape[0]
        for t in reversed(range(xs.shape[0])):
            rho = rk4_step(lambda r, _: drive[t] - M[t] @ r, -self.cfg.dt, rho, None)
            rhos[t] = rho
        rhos = torch.stack(rhos)  # (H, n)
        Bt_rho = (B.transpose(-1, -2) @ rhos[..., None])[..., 0]  # (H, m)
        du = -(self.R_inv @ Bt_rho[..., None])[..., 0]
        djdlam = (Bt_rho * du).sum(-1)
        return du, djdlam

    def _target_dist(self, pdf_ctx, pstate, samples, temp, plot: bool = False,
                     use_prior: bool = False, with_aux: bool = False):
        """Target density at the samples: the model pdf (or the scene prior,
        or uniform) shaped by the coverage of the visited-state memory.
        ``plot`` takes the model pdf and the coverage exponent whatever the
        flags. ``with_aux`` also returns {'pdf': raw model pdf, 'spread':
        mean normalized coverage}, which the trainer's entropy schedule
        reuses."""
        cfg = self.cfg
        rl = self._robot_lim
        aux = {}
        outside = ((samples < rl[:, 0]) | (samples > rl[:, 1])).any(1)
        if cfg.uniform_tdist and not plot:
            p = renormalize(torch.ones(samples.shape[0], device=samples.device))
        else:
            p = self.pdf_fn(pdf_ctx, samples)
            aux["pdf"] = p
            if use_prior:
                d = self.prior_dist.means.shape[1]
                p = renormalize(self.prior_dist.pdf(samples[:, :d]))
        if cfg.weight_env or cfg.weight_temp or plot:
            traj_all, mask = pstate.memory.get_all()
            spread = traj_spread(traj_all, samples, self._explr_idx, self.std,
                                 traj_mask=mask)
            spread = spread / spread.max().clamp(min=1e-30)
            nonempty = pstate.memory.size > 0
            zero = torch.zeros((), device=samples.device)
            aux["spread"] = torch.where(nonempty, spread.mean(), zero)
            spread = torch.where(outside, torch.ones_like(spread), spread)
            spread = torch.where(nonempty, spread, torch.zeros_like(spread))
            if cfg.weight_env and not plot:
                p = p + (1.0 - spread) * p.min()
            else:
                p = p ** spread.mean()
            p = renormalize(p)
        if with_aux:
            return p ** temp, aux
        return p ** temp

    def _saturate(self, u):
        if self.cfg.saturate:
            return torch.tanh(u / 0.1) * self.control_lim[:, 1]
        return torch.clamp(u, self.control_lim[:, 0], self.control_lim[:, 1])

    def _line_search(self, cost_fn, t_app, u_app, u, idx: int, J0):
        """Application-window search. All candidate windows (lam = 1 ..
        max_app_dur) are costed in one batched call; the sequential
        early-stopping acceptance then runs as a masked loop over the cost
        vector. Returns (tau_i, tau_f, success) as () tensors."""
        H = self.cfg.horizon
        mad = self.cfg.max_app_dur
        dev = u.device
        i64 = lambda v: torch.full((), v, dtype=torch.int64, device=dev)
        w = torch.where
        lam0 = w((t_app == 0) | (t_app == H - 1), i64(min(H, mad)),
                 w(t_app == idx, (H - t_app).clamp(max=mad),
                   torch.minimum(torch.minimum(t_app - idx, H - t_app - idx),
                                 i64((mad + 1) // 2))))
        lam0 = lam0.clamp(min=1)

        lams = torch.arange(1, mad + 1, device=dev)
        tis = w(t_app == idx, t_app.expand(mad), w(t_app == H - 1, lams - 1, t_app - lams))
        tfs = w(t_app == idx, lams + 1, w(t_app == H - 1, t_app.expand(mad), t_app + lams + 1))
        t = torch.arange(H, device=dev)
        masks = (t[None, :] >= tis[:, None]) & (t[None, :] < tfs[:, None])  # (mad, H)
        u_variants = w(masks[:, :, None], u_app[None, None, :], u[None, :, :])
        Js = cost_fn(u_variants)  # (mad,)

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
        return w(take_cur, ti, ti_l), w(take_cur, tf, tf_l), done | take_cur

    # ------------------------------------------------------------------
    def plan(self, pstate: PlannerState, pdf_ctx, temp: float = 1.0,
             use_prior: bool = False, samples=None, hist_idx=None):
        """One planner call. Draws the target samples (uniform in the
        limits; with ``sample_near_current_loc`` a tenth of them normal
        around the current state) and the history sample from
        ``pstate.gen``, unless ``samples`` (num_target_samples, d) and
        ``hist_idx`` (num_traj_samples,) feed them. ``add_recent_history``
        appends the last H visited states to the samples, unmasked.
        Returns (pstate, info)."""
        cfg = self.cfg
        if samples is None:
            samples = self._draw_samples(pstate)
        if cfg.add_recent_history:
            recent, _ = pstate.memory.get_recent(cfg.horizon)
            samples = torch.cat([samples, recent[:, self._explr_idx]], 0)
        traj_hist, hist_mask = pstate.memory.sample(
            cfg.num_traj_samples, pstate.gen, idx=hist_idx)
        return self.plan_with_inputs(pstate, pdf_ctx, samples, traj_hist,
                                     hist_mask, temp=temp, use_prior=use_prior)

    def _draw_samples(self, pstate: PlannerState):
        cfg = self.cfg
        lo, hi = pstate.lims[:, 0], pstate.lims[:, 1]
        n = cfg.num_target_samples
        n_uniform = int(n * 0.9) if cfg.sample_near_current_loc else n
        samples = torch.rand((n_uniform, lo.shape[0]), generator=pstate.gen,
                             device=lo.device) * (hi - lo) + lo
        if not cfg.sample_near_current_loc:
            return samples
        near = torch.randn((n - n_uniform, lo.shape[0]), generator=pstate.gen,
                           device=lo.device) * (self.std * 4.0) \
            + pstate.dyn.x[self._explr_idx]
        return torch.cat([samples, near], 0)

    def plan_with_inputs(self, pstate: PlannerState, pdf_ctx, samples,
                         traj_hist, hist_mask, temp: float = 1.0,
                         use_prior: bool = False):
        """The planner call after sampling: target shaping, base footprint
        and the hybrid inner loop on given (samples, history) inputs."""
        cfg = self.cfg
        dev = samples.device
        p, tdist_aux = self._target_dist(pdf_ctx, pstate, samples, temp,
                                         use_prior=use_prior, with_aux=True)
        q_base = traj_footprint(traj_hist, samples, self._explr_idx, self.std,
                                traj_mask=hist_mask)
        p_n = cost_norm(p)

        def cost_fn(u_test):
            return self._cost(pstate.dyn, u_test, samples, p_n, q_base, pstate.barrier)

        u = pstate.u
        last_cost = cost_fn(u)
        q_keep = renormalize(q_base)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for idx in range(cfg.num_iters):
            u_eff, xs, A, B, dbarr, dmu = self._forward(pstate, u, idx)
            q_iter = traj_footprint(xs, samples, self._explr_idx, self.std)
            q = renormalize(q_base + q_iter)
            du, djdlam = self._backward(samples, p, q, xs, A, B, dbarr, dmu)
            u_star = self._saturate(u_eff + cfg.alpha * du)
            if cfg.ctrl_app_search:
                u_new, step_done = self._apply(cost_fn, u, u_eff, u_star, djdlam, idx,
                                               last_cost)
            else:
                u_new, step_done = u_star, torch.zeros_like(done)
            cost = cost_fn(u_new)
            cost_break = (last_cost <= cost) if idx > 0 else torch.zeros_like(done)
            accept = ~done & ~step_done & ~cost_break
            u = torch.where(accept, u_new, u)
            last_cost = torch.where(accept, cost, last_cost)
            q_keep = torch.where(accept, q, q_keep)
            done = done | step_done | cost_break
        u = torch.nan_to_num(u)
        last_plan = self._rollout(pstate.dyn, u)

        q_n = cost_norm(q_keep)
        d_kl = (p_n * torch.log(p_n / q_n)).sum()
        pstate = dataclasses.replace(pstate, u=u, last_plan=last_plan)
        info = dict(samples=samples, p=p, q=q_keep, cost=d_kl,
                    planned_traj=last_plan[:, self._explr_idx])
        if "pdf" in tdist_aux:
            info["tdist_pdf"] = tdist_aux["pdf"]
        if "spread" in tdist_aux:
            info["tdist_spread"] = tdist_aux["spread"]
        return pstate, info

    def _apply(self, cost_fn, u, u_eff, u_star, djdlam, idx: int, last_cost):
        """Apply u_star at the slot t_app where the cost falls fastest, over
        a fixed window (``fixed_lam``) or the line search's. ``full_cost``
        takes t_app from the costs of the H one-slot substitutions of u_star
        into the nominal plan, renormalized, instead of djdlam. Returns
        (u_new, step_done); a value at t_app that is not negative stops the
        loop without updating."""
        cfg = self.cfg
        H = cfg.horizon
        t = torch.arange(H, device=u.device)
        if cfg.full_cost:
            slot = torch.eye(H, dtype=torch.bool, device=u.device)[:, :, None]
            djdlam = renormalize(cost_fn(torch.where(slot, u_star[None], u[None]))) - 1.0
        t_app = torch.argmin(djdlam)
        u_app = u_star.index_select(0, t_app.reshape(1))[0]
        if cfg.fixed_lam:
            m = ((t >= t_app) & (t < t_app + cfg.lam))[:, None]
        else:
            # the windows are costed on the nominal plan, applied to u_eff
            ti, tf, ls_ok = self._line_search(cost_fn, t_app, u_app, u, idx, last_cost)
            m = (ls_ok & (t >= ti) & (t < tf))[:, None]
        step_done = ~(djdlam.gather(0, t_app.reshape(1))[0] < 0)
        return torch.where(m, u_app[None], u_eff), step_done

    def save_update(self, pstate: PlannerState, full_state, save: bool = True):
        """Sync the planner to a measured state: nan guard, closest-plan-
        point warm-start shift (Roll rolls the plan, Zero zeroes it, the
        others keep it), velocity smoothing, memory push."""
        full_state = full_state.float()
        bad = torch.isnan(full_state).any()
        full_state = torch.nan_to_num(full_state)
        m = self.dyn.num_actions

        dist = torch.linalg.norm(pstate.last_plan - full_state[None, :], dim=1)
        policy_idx = torch.argmin(dist)
        planned = pstate.last_plan.index_select(0, policy_idx.reshape(1))[0]
        vs = self.cfg.vel_smoothing
        vel = vs * full_state[m:] + (1 - vs) * planned[m:]
        dyn_new = self.dyn.init(torch.cat([full_state[:m], vel]))
        u_new = pstate.u
        if isinstance(self.policy, (RollPolicy, ZeroPolicy)):
            u_new = self.policy.shift(pstate.u, -policy_idx)

        memory = pstate.memory
        if save:
            memory.push(dyn_new.x, skip=bad)  # a nan measurement is not pushed
        dyn_out = DynState(x=torch.where(bad, pstate.dyn.x, dyn_new.x),
                           R=torch.where(bad, pstate.dyn.R, dyn_new.R))
        u_out = torch.where(bad, pstate.u, u_new)
        return dataclasses.replace(pstate, dyn=dyn_out, u=u_out, memory=memory)

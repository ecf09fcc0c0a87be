"""Sample-based KL-ergodic MPC in torch (port of
``ealv_tpu/control/klerg.py``).

The JAX planner is one jitted program whose fixed-trip ``lax.scan``s carry
``done`` masks. Here they are Python loops over the same fixed trip counts
with ``torch.where`` on the masks: no call in a planner call synchronises
with the device (no ``.item()``, ``bool(tensor)``, ``.cpu()`` or tensor
built from Python data; ``chip_smoke.py`` runs ``plan_step`` under
``torch.cuda.set_sync_debug_mode("error")``), and the number of K1 launches
per call is fixed (7 at the default config: the target spread, the base
footprint, and one per inner iteration's forward pass). The horizon
recurrences (``control/horizon.py``) are one launch a call on the card: a
rollout for every cost, forward pass and the final plan (17 a call at the
default config) and a costate sweep for every backward pass (5). The
inner iteration's bookkeeping and the cost it reads (``control/descent.py``:
the slot and the windows, the window search's acceptance, the step's
acceptance; ``plan_cost``, the footprint, KL and barrier of a plan or of a
batch of candidates) are one launch each there: three bookkeeping launches
an iteration, where they were about 170 torch operations, and 11 cost
launches a call at the default config (the initial cost, then each
iteration's candidate windows and its new plan), where each cost was about
39. That leaves about 430 launches a call at the production config at xyw
and 540 at xyzrpw (840 and 950 before the cost kernel, about 1,800 before
the bookkeeping kernels, 7,700 and 20,000 with the recurrences' per-step
loops). ``full_cost`` costs its H
one-slot substitutions as one more batch, one rollout and one cost launch,
as the line search costs its windows. Models whose linearization depends on
the state (``dyn.state_dependent``) are linearized at every step of the
horizon.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops import (
    renormalize,
    cost_norm,
    traj_footprint,
    traj_spread,
    kldiv_grad_batch,
)
from ..data.replay import TrajMemory
from .descent import accept_step, accept_window, choose_slot, plan_cost
from .dynamics import DynState
from .horizon import costate, rollout
from .policies import BarrierPushPolicy, RollPolicy, ZeroPolicy
from .target_dists import prior_dist as make_prior


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
        self.prior_dist = prior_dist if prior_dist is not None else make_prior(states, device)
        self.states = states
        self.explr_locs = list(explr_locs)
        self._explr_cols = tuple(int(c) for c in self.explr_locs)  # for the cost kernel
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
    def init_state(self, x0, robot_lim, barrier, buffer_capacity: int = 3000,
                   explr_lim_scale: float = 1.0, seed: int = 0) -> PlannerState:
        robot_lim = robot_lim.float()
        self._robot_lim = robot_lim
        span = (robot_lim[:, 1] - robot_lim[:, 0])[:, None]
        lims = robot_lim + torch.tensor([[-1.0, 1.0]], device=robot_lim.device) \
            * span * (explr_lim_scale - 1.0) / 2.0
        dyn0 = self.dyn.init(x0.float())
        u0 = torch.zeros((self.cfg.horizon, self.dyn.num_actions), device=x0.device)
        gen = torch.Generator(device=x0.device)
        gen.manual_seed(seed)
        return PlannerState(
            u=u0, dyn=dyn0,
            memory=TrajMemory.create(buffer_capacity, self.dyn.num_states, x0.device),
            lims=lims, barrier=barrier, last_plan=self._rollout(dyn0, u0), gen=gen)

    def update_lims(self, pstate: PlannerState, idx, lims, robot_ctrl_lim=None):
        """Set the sampling limits of the explored dims ``idx``; with
        ``robot_ctrl_lim`` the barrier takes [new position lims; control
        lims] too."""
        new_lims = pstate.lims.clone()
        new_lims[idx] = torch.as_tensor(lims, dtype=torch.float32, device=new_lims.device)
        barrier = pstate.barrier
        if robot_ctrl_lim is not None:
            n_pos = self.dyn.num_actions
            barrier = barrier.update_lims(torch.cat([new_lims[:n_pos],
                                                     robot_ctrl_lim.float()], 0))
        return dataclasses.replace(pstate, lims=new_lims, barrier=barrier)

    # ------------------------------------------------------------------
    def _traj_states(self, dyn0: DynState, u):
        """(..., H, n) post-step states of plan(s) u (..., H, m); the whole
        state, R included, is carried through the steps."""
        return self._rollout(dyn0, u)[..., 1:, :]

    def _rollout(self, dyn0: DynState, u):
        """(..., H+1, n) states from rolling plan(s) u open loop, start
        included: one rollout kernel launch on the card."""
        return rollout(self.dyn, None, dyn0.x, dyn0.R, u)[0]

    def _cost(self, dyn0, u_test, samples, p_n, q_base, barrier):
        """KL + barrier cost of a plan (H, m) -> (), or of candidates
        (K, H, m) -> (K,): one rollout launch and one ``plan_cost`` launch
        on the card."""
        return plan_cost(self._traj_states(dyn0, u_test), samples, p_n, q_base, self.std,
                         self._explr_idx, self._explr_cols, barrier)

    def _forward(self, pstate: PlannerState, u, idx: int):
        """Forward pass collecting linearizations at the pre-step states.
        Returns (u_eff (H, m), pre-step states (H, n), A (H, n, n),
        B (H, n, m), dbarr (H, n), dmu (H, m, n)). BarrierPush ignores the
        nominal controls on the first iteration."""
        if idx == 0 and isinstance(self.policy, BarrierPushPolicy):
            u = torch.zeros_like(u)
        s = pstate.dyn
        xs, Rs, u_eff = rollout(self.dyn, self.policy, s.x, s.R, u)
        xs, Rs = xs[:-1], Rs[:-1]  # the pre-step states
        H, n = xs.shape
        if self.dyn.state_dependent:
            A, B = self.dyn.get_lin(DynState(x=xs, R=Rs), u_eff)
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
        # rho' = drive - (A + B dmu)^T rho, one costate kernel launch on the card
        rhos = costate(dgdx - dbarr, A + B @ dmu, self.cfg.dt)  # (H, n)
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

    # ------------------------------------------------------------------
    def plan(self, pstate: PlannerState, pdf_ctx, temp: float = 1.0,
             use_prior: bool = False, samples=None, hist_idx=None):
        """One planner call. Draws the target samples (uniform in the
        limits; with ``sample_near_current_loc`` a tenth of them normal
        around the current state) and the history sample from
        ``pstate.gen``, unless ``samples`` (num_target_samples, d) and
        ``hist_idx`` (num_traj_samples,) feed them. ``add_recent_history``
        appends the last H visited states to the samples, unmasked.
        Returns (pstate, info). The tracer's device spans: ``decode`` from
        here to the base footprint, ``descent`` from there to the end."""
        from ..runtime import tracing  # the runtime package imports this module
        tracing.begin("decode")
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
        from ..runtime import tracing
        cfg = self.cfg
        dev = samples.device
        p, tdist_aux = self._target_dist(pdf_ctx, pstate, samples, temp,
                                         use_prior=use_prior, with_aux=True)
        q_base = traj_footprint(traj_hist, samples, self._explr_idx, self.std,
                                traj_mask=hist_mask)
        tracing.end("decode")
        tracing.begin("descent")
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
                u_new, step_done = u_star, None
            u, last_cost, q_keep, done = accept_step(u_new, cost_fn(u_new), q, step_done, u,
                                                     last_cost, q_keep, done, idx > 0)
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
        tracing.end("descent")
        return pstate, info

    def _apply(self, cost_fn, u, u_eff, u_star, djdlam, idx: int, last_cost):
        """Apply u_star at the slot t_app where the cost falls fastest, over
        a fixed window (``fixed_lam``) or the line search's: all candidate
        windows (lam = 1 .. max_app_dur) are costed in one batched call and
        the sequential early-stopping acceptance runs as a masked loop over
        the cost vector (``control/descent.py``). ``full_cost`` takes t_app
        from the costs of the H one-slot substitutions of u_star into the
        nominal plan, renormalized, instead of djdlam. Returns (u_new,
        step_done); a value at t_app that is not negative stops the loop
        without updating."""
        cfg = self.cfg
        H = cfg.horizon
        if cfg.full_cost:
            slot = torch.eye(H, dtype=torch.bool, device=u.device)[:, :, None]
            djdlam = renormalize(cost_fn(torch.where(slot, u_star[None], u[None]))) - 1.0
        if cfg.fixed_lam:
            s = choose_slot(djdlam, u, u_eff, u_star, idx, lam=cfg.lam)
            return s.plans, s.step_done
        # the windows are costed on the nominal plan, applied to u_eff
        s = choose_slot(djdlam, u, u_eff, u_star, idx, max_app_dur=cfg.max_app_dur)
        return accept_window(cost_fn(s.plans), last_cost, s, u_eff, idx)[3], s.step_done

    def plot_dists(self, pstate: PlannerState, pdf_ctx, samples, plot_idx,
                   temp: float = 1.0):
        """Smoothed plot distributions: every explored dim but ``plot_idx``
        pinned to the current state, the shaped target and the footprint of
        the memory plus the last plan there. Returns (pplot_samples, pplot,
        qplot)."""
        cur = pstate.dyn.x[self._explr_idx]
        pplot_samples = cur.expand(samples.shape).clone()
        pplot_samples[:, plot_idx] = samples[:, plot_idx]
        pplot = self._target_dist(pdf_ctx, pstate, pplot_samples, temp, plot=True)
        traj_all, mask = pstate.memory.get_all()
        traj = torch.cat([traj_all, pstate.last_plan], 0)
        mask = torch.cat([mask, mask.new_ones(pstate.last_plan.shape[0])], 0)
        qplot = renormalize(traj_footprint(traj, pplot_samples, self._explr_idx,
                                           self.std, traj_mask=mask))
        return pplot_samples, pplot, qplot

    def step(self, pstate: PlannerState, pdf_ctx, temp: float = 1.0,
             save_update: bool = False, samples=None, hist_idx=None):
        """Plan and apply the first control; with ``save_update`` the planner
        syncs to the predicted state. ``samples``/``hist_idx`` feed the
        draws as in ``plan``. Returns (pstate, explored state, velocity,
        control, info)."""
        pstate, info = self.plan(pstate, pdf_ctx, temp, samples=samples,
                                 hist_idx=hist_idx)
        ctrl = pstate.u[0]
        dyn2 = self.dyn.step(pstate.dyn, ctrl)
        if save_update:
            pstate = self.save_update(dataclasses.replace(pstate, dyn=dyn2), dyn2.x)
        m = self.dyn.num_actions
        return pstate, dyn2.x[self._explr_idx], dyn2.x[m:], ctrl, info

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

"""One tick of the explore-and-learn loop and of the exploration-only loop,
recomputed in plain torch from the state before the tick.

The tick follows the port's default path (``Experiment._tick`` with
``absorb_step`` and ``train_call``, ``EvalExperiment._tick``): sync the
planner to the measured state, plan with the KL-ergodic MPC, turn the plan
into a velocity command, step the free-flying env and render the camera;
in the learning loop push the sample, reseed the target's latent and, on a
throttled tick, grade the entropy and make one trainer call of
``num_learning_opt`` Adam steps. It makes the same draws from the same
generators in the same order, so a generator set to the state the program's
had before the tick gives the same samples, history indices, batches and
noise.

The tick starts from a ``snap`` (a dict of tensors and host ints that the
benchmark copied from the program's state before the tick, ``traffic/``);
everything it computes it computes again here. ``cast`` sets the precision
of the CVAE's products (``cvae.CASTS``: the configuration's compute dtype;
``cvae.fp8_round``: the control), ``ring_cast`` that of the image the ring
stores.
"""

from __future__ import annotations


import torch

from . import cvae as cvae_mod
from .barrier import setup_barrier
from .config import RAW_STATES, TRAY_LIM, ExperimentConfig
from .dynamics import DynState, make_dynamics
from .env import EnvState, SyntheticEnv
from .klerg import KlergConfig, KlergPlanner, PlannerState
from .losses import cvae_loss
from .policies import RollPolicy
from .renderer import TrayScene
from .replay import ReplayBuffer, TrajMemory

TRAY6 = tuple(TRAY_LIM[s] for s in "xyzrpw")


def ws_conversion(pt, in_lim, out_lim):
    """Affine map between workspace boxes (n, 2); trailing dims of ``pt``
    beyond ``len(in_lim)`` are dropped."""
    ilim = in_lim[:, 1] - in_lim[:, 0]
    olim = out_lim[:, 1] - out_lim[:, 0]
    return (pt[..., : ilim.shape[0]] - in_lim[:, 0]) / ilim * olim + out_lim[:, 0]


def throttle(cfg, explr_step: int, learning_ind: int, train_every: int) -> bool:
    """Whether a tick makes its one trainer call, from the host counters at
    its start (the port's ``Experiment._throttle`` at one call a tick)."""
    return (learning_ind < cfg.target_learning_rate * (explr_step + 1
                                                      - cfg.frames_before_training)
            and explr_step + 1 >= cfg.frames_before_training
            and explr_step % train_every == 0)


class Explored:
    """The explored states' place in the env's 6-DoF pose and their
    workspace limits (the position states only: no brightness)."""

    def __init__(self, cfg: ExperimentConfig, device):
        t = lambda a: torch.as_tensor(a, device=device)
        self.pose_sel = torch.tensor([RAW_STATES.rfind(s) for s in cfg.states], device=device)
        self.tray_lim, self.robot_lim = t(cfg.tray_lim), t(cfg.robot_lim)
        self.tray_ctrl_lim, self.robot_ctrl_lim = t(cfg.tray_ctrl_lim), t(cfg.robot_ctrl_lim)
        self.tray_full = torch.cat([self.tray_lim, self.tray_ctrl_lim], 0)
        self.robot_full = torch.cat([self.robot_lim, self.robot_ctrl_lim], 0)

    def measured(self, env: EnvState):
        return ws_conversion(torch.cat([env.pose[self.pose_sel], env.vel[self.pose_sel]]),
                             self.tray_full, self.robot_full)

    def command(self, vel_pred):
        vel = ws_conversion(vel_pred, self.robot_ctrl_lim, self.tray_ctrl_lim)
        vel = torch.clamp(vel, self.tray_ctrl_lim[:, 0], self.tray_ctrl_lim[:, 1])
        vel6 = torch.zeros(6, device=vel.device)
        vel6[self.pose_sel] = vel
        return vel6


class Tick:
    """The pieces of a tick for one configuration: dynamics, planner, env.
    ``learning`` picks the explore-and-learn planner (target shaped by the
    coverage exponent) over the exploration-only one (target as it is)."""

    def __init__(self, cfg: ExperimentConfig, device, learning: bool,
                 cast=cvae_mod.no_cast, ring_cast=cvae_mod.no_cast, half_batch: bool = False,
                 stuck: bool = False):
        reject = [k for k, v in dict(sim_backend="free", explr_method="entklerg",
                                     use_z_ensemble=False, learn_force=False, dx=False,
                                     hyper_from_planner=True, prior_steps=0,
                                     decoder_mode="conv_transpose",
                                     data_to_ctrl_rate=1).items()
                  if getattr(cfg, k) != v]
        if reject or cfg.states != cfg.states.lower() or "b" in cfg.states:
            raise NotImplementedError(f"the reference tick does not cover {reject or cfg.states}")
        self.cfg, self.device, self.learning = cfg, torch.device(device), learning
        self.cast, self.ring_cast = cast, ring_cast
        # a planted fault: each step trains on half of its batch, the mean
        # taken over the rest (the draws are made for the whole batch)
        self.half_batch = half_batch
        # a planted fault: the tick returns its state unchanged
        self.stuck = stuck
        self.ex = Explored(cfg, device)
        self.dyn = make_dynamics(cfg.states, dt=cfg.dt, device=device)
        kcfg = KlergConfig(horizon=cfg.horizon, num_target_samples=cfg.num_target_samples,
                           num_traj_samples=cfg.num_traj_samples, dt=cfg.dt, R=cfg.R,
                           std=cfg.std, vel_smoothing=0.5,
                           weight_temp=learning, weight_env=False)
        self.planner = KlergPlanner(kcfg, self.dyn,
                                    RollPolicy(self.dyn.num_actions, self.dyn.num_states),
                                    lambda ctx, s: ctx[0].pdf(ctx[1], s), cfg.states,
                                    explr_locs=list(range(cfg.s_dim)), device=device)
        self.planner._robot_lim = self.ex.robot_lim.float()
        self.barrier, _ = setup_barrier(cfg.states, self.ex.robot_lim, self.ex.robot_ctrl_lim,
                                        list(range(cfg.s_dim)))
        self.env = SyntheticEnv(tray_lim=TRAY6, dt=cfg.dt / 5.0, img_hw=cfg.image_dim[:2],
                                device=str(device))
        self.scene = TrayScene.default(device)

    def make_model(self, seed=None) -> cvae_mod.CVAE:
        """The CVAE at the configuration's sizes, with weights from ``seed``
        drawn as the port's ``Experiment.init`` draws them (a CPU generator,
        then moved), or uninitialized."""
        cfg = self.cfg
        model = cvae_mod.CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                              hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
                              cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels,
                              y_logvar_dim=cfg.y_logvar_dim, cast=self.cast)
        if seed is not None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(self.device)

    def start_pose(self):
        return torch.tensor([(lo + hi) / 2 for lo, hi in TRAY6], device=self.device)

    # ------------------------------------------------------------------
    def _pstate(self, snap) -> PlannerState:
        gen = torch.Generator(device=self.device)
        gen.set_state(snap["planner_gen"])
        memory = TrajMemory(buf=snap["mem_buf"].clone(), pos=snap["mem_pos"].clone(),
                            size=snap["mem_size"].clone())
        return PlannerState(u=snap["u"], dyn=DynState(x=snap["dyn_x"], R=snap["dyn_R"]),
                            memory=memory, lims=snap["lims"], barrier=self.barrier,
                            last_plan=snap["last_plan"], gen=gen)

    def explore(self, snap, pdf_ctx, u=None):
        """The exploration half: plan from the measured state, command,
        env step and render. The command is taken from the plan ``u`` where
        it is given (the program's own: the stages after the plan are then
        checked by themselves, whichever way a near tie in the planner's
        discrete choices fell), else from this plan. Returns (this plan,
        info, env, robot state, image, force)."""
        env = EnvState(pose=snap["pose"], vel=snap["vel"], brightness=snap["brightness"],
                       scene=self.scene)
        pstate = self.planner.save_update(self._pstate(snap), self.ex.measured(env), save=True)
        pstate, info = self.planner.plan(pstate, pdf_ctx)
        m = self.dyn.num_actions
        x_pred = self.dyn.step(pstate.dyn, (pstate.u if u is None else u)[0]).x
        env = self.env.step_vel(env, self.ex.command(x_pred[m:]))
        _, _, force, img = self.env.observe(env)
        return pstate.u, info, env, self.ex.measured(env)[: self.cfg.s_dim], img, force

    def stuck_tick(self, snap) -> dict:
        """What a tick that leaves its state unchanged reports: the robot
        state and camera image before it, its plan and latent as they were,
        no cost, no trainer call and, in the learning loop, no ring row
        (the row the tick should have pushed reads as the ring's zeros)."""
        env = EnvState(pose=snap["pose"], vel=snap["vel"], brightness=snap["brightness"],
                       scene=self.scene)
        _, _, _, img = self.env.observe(env)
        out = dict(cost=torch.zeros((), device=self.device), u=snap["u"],
                   robot_state=self.ex.measured(env)[: self.cfg.s_dim],
                   image=torch.zeros_like(img) if self.learning else img)
        if self.learning:
            out["z"] = snap["z"]
        return out

    def eval_tick(self, snap, model, mstate, u=None) -> dict:
        """One exploration-only tick toward the frozen CVAE's pdf."""
        if self.stuck:
            return self.stuck_tick(snap)
        plan, info, env, robot_state, img, _ = self.explore(snap, (model, mstate), u)
        return dict(cost=info["cost"], robot_state=robot_state, image=img, u=plan)

    def learn_tick(self, snap, ring_y, train_every: int, u=None) -> dict:
        """One explore-and-learn tick (``u`` as in ``explore``). ``ring_y``
        holds the ring's images: every row the program had pushed before
        the tick (the ring is appended to and never wraps in a run)."""
        if self.stuck:
            return self.stuck_tick(snap)
        cfg, dev = self.cfg, self.device
        model = self.make_model()
        model.load_state_dict(snap["params"])
        mstate = cvae_mod.ModelState(*(snap[k] for k in (
            "seed_x", "seed_y", "seed_force", "z", "z_buff", "initialized")))
        plan, info, env, robot_state, img, force = self.explore(snap, (model, mstate), u)
        force = force.float().reshape(-1)

        ring = ReplayBuffer(x=snap["ring_x"].clone(), y=ring_y.float(),
                            force=snap["ring_force"].clone(), y_var=snap["ring_y_var"].clone(),
                            beta=torch.zeros(1, device=dev), gamma=torch.zeros(1, device=dev),
                            beta_pos=snap["ring_pos"] * 0, beta_size=snap["ring_pos"] * 0,
                            explr_ind=snap["ring_pos"] * 0, pos=snap["ring_pos"].clone(),
                            size=snap["ring_size"].clone(), total=snap["ring_total"].clone())
        pushed = self.ring_cast(img)
        ring.push(robot_state, pushed, force)
        mstate = cvae_mod.update_dist(model, mstate, robot_state, img, mstate.seed_force)
        out = dict(cost=info["cost"], robot_state=robot_state, image=pushed, u=plan,
                   z=mstate.z)
        if not throttle(cfg, snap["explr_step"], snap["learning_ind"], train_every):
            return out
        spread = info["tdist_spread"]
        ent = info["tdist_pdf"] ** spread
        ent = ent / ent.max().clamp(min=1e-30)
        grade = torch.pow(10.0, -torch.log10(ent.min().clamp(min=1e-30)) - cfg.xi).clamp(max=0.01)
        gen = torch.Generator(device=dev)
        gen.set_state(snap["trainer_gen"])
        out.update(self.train_call(model, snap, ring, grade.float(), spread.float(), gen),
                   beta=grade.float(), gamma=spread.float())
        return out

    def train_call(self, model, snap, ring: ReplayBuffer, beta, gamma, gen) -> dict:
        """``num_learning_opt`` Adam steps from the snapshot's moments, on
        weighted batches with the cross-decode loss. Returns the losses, the
        parameters and moments after the call and the first step's
        gradients, by parameter name."""
        cfg = self.cfg
        B = cfg.batch_size
        names = [n for n, _ in model.named_parameters()]
        # on the card Adam keeps its step count on the device and takes its
        # bias corrections there (``capturable``), as the configuration's
        # trainer does, so that a graph can replay it
        on_card = self.device.type == "cuda"
        opt = torch.optim.Adam(model.parameters(), lr=cfg.model_lr, capturable=on_card)
        for n, p in model.named_parameters():
            step = float(snap["step"][n])
            opt.state[p] = {"step": torch.tensor(step, device=p.device if on_card else None),
                            "exp_avg": snap["exp_avg"][n].clone(),
                            "exp_avg_sq": snap["exp_avg_sq"][n].clone()}
        losses, grad0 = [], None
        for _ in range(cfg.num_learning_opt):
            idx = ring.sample_indices(B, weighted=True, generator=gen)
            idx2 = ring.sample_indices(B, weighted=False, generator=gen)
            if self.half_batch:
                idx, idx2 = idx[: B // 2], idx2[: B // 2]
            x, y = ring.x[idx], ring.y[idx]
            out = model(x, y, x_decode=ring.x[idx2], train=True, generator=gen)
            loss, _ = cvae_loss(out, y, y2=ring.y[idx2], beta=beta, gamma=gamma,
                                gamma_weight=cfg.gamma_weight, other_locs=True)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if grad0 is None:
                grad0 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            opt.step()
            losses.append(loss.detach())
        return dict(losses=torch.stack(losses),
                    params={n: p.detach() for n, p in model.named_parameters()},
                    exp_avg={n: opt.state[p]["exp_avg"] for n, p in zip(names, model.parameters())},
                    exp_avg_sq={n: opt.state[p]["exp_avg_sq"]
                                for n, p in zip(names, model.parameters())},
                    grad0=grad0)

    def eval_target(self, seed: int):
        """The exploration-only cells' target: the CVAE with weights from
        ``seed``, its latent seeded from the camera at the start pose."""
        model = self.make_model(seed)
        start = self.start_pose()
        env = self.env.init(start, scene=self.scene)
        _, _, force, img = self.env.observe(env)
        robot = self.ex.measured(env)[: self.cfg.s_dim]
        mstate = cvae_mod.update_dist(model, cvae_mod.init_model_state(model, self.device),
                                      robot, img, torch.zeros(1, device=self.device))
        return model, mstate

"""The explore-and-learn experiment (port of ``ealv_tpu/runtime/agent.py``).

One ``tick`` syncs the planner to the measured state, plans with the
KL-ergodic MPC (or steps a baseline explorer), converts the plan to a
velocity command (and, with the brightness state ``b``, a brightness
command), steps the simulator (the free-flying end effector or the arm,
``sim/arm.py``) and renders the camera, pushes the
sample to the replay ring, reseeds z, and makes the throttled trainer
call. The state is updated in place and returned. The throttle counters
(``explr_step``, ``learning_ind``) are host ints, so the throttle branches
in Python and a tick never waits on the device. ``post_train_chunk`` is
the training that follows exploration: trainer calls with no exploration.

On the card (over no mesh, or an NCCL one) a whole tick runs as a
captured CUDA graph (``tick_graph``, a ``runtime/graphs.py``
``StepGraph``), as the JAX package runs ``run_chunk`` as one ``lax.scan``
over the tick, one graph for each pattern of the host values the tick
branches on (``_tick_pattern``:
which trainer calls run, the prior, the arm's drift corrections); a
post-training call likewise (``post_train_graph``). The host values the
tick computes with (the step it records in the hyperparameter ring, the
manual ramps) are staged into device scalars (``HostValues``). With
``tick_graph`` and ``post_train_graph`` set to None the experiment runs
eagerly. Over an NCCL mesh the graphs hold the data-parallel call's and
the sharded decode's collectives; a gloo mesh runs eagerly, as the CPU
does (``eager_reason`` says which).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.config import ExperimentConfig, RAW_STATES, TRAY_LIM
from ..utils.states import ws_conversion
from ..models import CVAE
from ..models.cvae import init_model_state, update_dist, ModelState
from ..data.replay import ReplayBuffer
from ..control.klerg import KlergConfig, KlergPlanner, PlannerState
from ..control.dynamics import make_dynamics
from ..control.policies import make_policy
from ..control.barrier import setup_barrier
from ..control.baselines import BaselineController, BaselineDraws, BaselineState
from ..sim.arm import ArmEnv, ArmState
from ..sim.env import SyntheticEnv, EnvState
from ..sim.renderer import TrayScene
from . import tracing
from .graphs import StepGraph, _addresses, _spec, module_key, optimizer_key, run_step
from .trainer import TrainerStatics, TrainDraws, train_call
from .schedules import HyperState, hyperparam_update, entropy_grade, \
    entropy_grade_spread, manual_ramp


@dataclasses.dataclass
class ExperimentState:
    model: CVAE  # holds the parameters
    opt: torch.optim.Optimizer
    mstate: ModelState
    pstate: PlannerState | BaselineState
    buf: ReplayBuffer
    env: EnvState | ArmState
    hyper: HyperState
    gen: torch.Generator  # the trainer's random stream
    explr_step: int = 0
    learning_ind: int = 0  # trainer calls so far


@dataclasses.dataclass
class TickDraws:
    """One tick's random draws, fed instead of drawn (for step-matched
    tests): the planner's target samples (N, d) and history indices
    (num_traj_samples,), or a baseline's ``BaselineDraws``; one
    ``TrainDraws`` per trainer call; and, where the entropy grade is not
    folded from the planner's decode, its uniform samples
    (num_target_samples, s_dim) per trainer call."""

    samples: torch.Tensor | None = None
    hist_idx: torch.Tensor | None = None
    train: list | None = None
    grade_samples: list | None = None
    baseline: BaselineDraws | None = None


@dataclasses.dataclass
class PostTrainDraws:
    """One post-exploration trainer call's random draws, fed instead of
    drawn: the entropy grade's uniform samples (num_target_samples, s_dim)
    and the trainer call's ``TrainDraws``."""

    samples: torch.Tensor
    train: TrainDraws


@dataclasses.dataclass
class HostValues:
    """The host values a captured tick or post-training call computes with,
    staged into device scalars before every step (a capture would freeze a
    host value): the exploration step the hyperparameter ring records and,
    per trainer-call slot of the tick, the manual ramps' beta and gamma."""

    explr_step: torch.Tensor  # () int64
    beta: torch.Tensor  # (train_calls_per_tick,)
    gamma: torch.Tensor

    @classmethod
    def create(cls, slots: int, device):
        return cls(explr_step=torch.zeros((), dtype=torch.int64, device=device),
                   beta=torch.zeros(slots, device=device),
                   gamma=torch.zeros(slots, device=device))

    def ramp(self, slot: int):
        return self.beta[slot], self.gamma[slot]


class ExploredStates:
    """Where the explored states sit in the env's 6-DoF pose and its
    brightness, and their workspace limits: the brightness state ``b`` has
    no pose slot, so it is inserted into measured states and split off
    commands at its place ``b_pos`` in the state string."""

    def __init__(self, cfg: ExperimentConfig, states: str, device):
        sub = [cfg.states.rfind(s) for s in states]
        t = lambda a: torch.as_tensor(a[sub], device=device)
        self.pose_sel = torch.tensor([RAW_STATES.rfind(s) for s in states if s != "b"],
                                     device=device)
        self.b_pos = states.rfind("b")  # -1 without b
        self.tray_lim, self.robot_lim = t(cfg.tray_lim), t(cfg.robot_lim)
        self.tray_ctrl_lim, self.robot_ctrl_lim = t(cfg.tray_ctrl_lim), t(cfg.robot_ctrl_lim)
        self.tray_full_lim = torch.cat([self.tray_lim, self.tray_ctrl_lim], 0)
        self.robot_full_lim = torch.cat([self.robot_lim, self.robot_ctrl_lim], 0)

    def _insert_b(self, v, value):
        if self.b_pos < 0:
            return v
        return torch.cat([v[: self.b_pos], value.reshape(1).to(v), v[self.b_pos:]])

    def start(self, tray_pose6):
        """Robot-coordinate start position at a tray pose, brightness at
        mid-range."""
        b_mid = torch.tensor(sum(TRAY_LIM["b"]) / 2, device=tray_pose6.device)
        start = self._insert_b(tray_pose6[self.pose_sel], b_mid)
        return ws_conversion(start, self.tray_lim, self.robot_lim)

    def measured(self, env: EnvState | ArmState):
        """(pose, vel) tray -> robot coords over the explored states, the
        brightness and a zero velocity at ``b_pos``."""
        return self.measured_obs(env.pose, env.vel, env.brightness)

    def measured_obs(self, pose6, vel6, brightness):
        """``measured`` from an observed pose (6,), twist (6,) and
        brightness (), as a bridge reports them."""
        pose = self._insert_b(pose6[self.pose_sel], brightness)
        vel = self._insert_b(vel6[self.pose_sel], vel6.new_zeros(()))
        return ws_conversion(torch.cat([pose, vel]), self.tray_full_lim,
                             self.robot_full_lim)

    def command(self, x_pred, vel_pred):
        """The predicted robot-coordinate (position, velocity) as a clipped
        tray-frame 6-twist and, with ``b``, the brightness command (the
        predicted position at ``b_pos`` in tray coords; else None)."""
        vel = ws_conversion(vel_pred, self.robot_ctrl_lim, self.tray_ctrl_lim)
        vel = torch.clamp(vel, self.tray_ctrl_lim[:, 0], self.tray_ctrl_lim[:, 1])
        b_cmd = None
        if self.b_pos >= 0:
            b_cmd = ws_conversion(x_pred, self.robot_lim, self.tray_lim)[self.b_pos]
            vel = torch.cat([vel[: self.b_pos], vel[self.b_pos + 1:]])
        vel6 = torch.zeros(6, device=vel.device)
        vel6[self.pose_sel] = vel
        return vel6, b_cmd


def sim_carry(pstate, env) -> tuple:
    """What a captured step replaces of the planner's (or baseline's) and
    the env's states: the planner state but its generator, the env state
    but the arm's host counter."""
    if isinstance(env, ArmState):
        env = dataclasses.replace(env, count=0)
    return dataclasses.replace(pstate, gen=None), env


def with_sim_carry(pstate, env, carry) -> tuple:
    """The planner and env states of ``carry`` (``sim_carry``'s) with
    ``pstate``'s generator and ``env``'s host counter."""
    new_pstate, new_env = carry
    if isinstance(new_env, ArmState):
        new_env = dataclasses.replace(new_env, count=env.count)
    return dataclasses.replace(new_pstate, gen=pstate.gen), new_env


def drift_key(env_model, env, n: int) -> tuple:
    """Which of the next ``n`` velocity commands correct the arm's drift,
    a pattern key of a captured step (the correction branches on the
    arm's host counter); () off the arm."""
    if not isinstance(env, ArmState) or env_model.drift_every <= 0:
        return ()
    return tuple((env.count + j + 1) % env_model.drift_every == 0 for j in range(n))


def advance_env(env, n: int):
    """``env`` after a captured step of ``n`` velocity commands: the arm's
    host counter moves on."""
    if isinstance(env, ArmState):
        return dataclasses.replace(env, count=env.count + n)
    return env


def step_base(owner, generators, carry, *reads) -> tuple:
    """The base key of a captured step: the planner's (or baseline's) own
    tensors by address, the generators themselves (held, so that a new
    generator cannot take a dead one's identity), the carry's structure,
    and ``reads``, the keys of what else the step reads in place."""
    return (tuple(generators), _spec(carry),
            _addresses(v for v in vars(owner).values() if isinstance(v, torch.Tensor)), *reads)


def reject_unported(cfg: ExperimentConfig):
    """Raise ``NotImplementedError`` on the configurations the port has no
    reference for."""
    if cfg.states != cfg.states.lower():
        raise NotImplementedError(
            f"states={cfg.states!r}: velocity (upper-case) states have no limits in "
            "the experiment's tables; the JAX ExperimentConfig fails there too "
            "(ealv_tpu/utils/config.py:156, TRAY_LIM has no upper-case keys)")


class Experiment:
    """Builds and runs the online-learning experiment on ``device``."""

    def __init__(self, cfg: ExperimentConfig, train_calls_per_tick: int = 3,
                 scene: Optional[TrayScene] = None, train_every: int = 1,
                 device="cuda", mesh=None):
        reject_unported(cfg)
        if cfg.use_magnitude:
            raise NotImplementedError(
                "use_magnitude=True: the JAX Experiment fails on its first tick "
                "there (ealv_tpu/control/klerg.py:550, save_update subtracts the "
                "measured (pos, vel) state from the speed model's wider plan), "
                "so the port has no reference to match; the speed model is "
                "ported at the planner level")
        self.cfg = cfg
        self.device = torch.device(device)
        # data-parallel over a parallel.Mesh: every rank runs this whole
        # experiment from the same seed; the trainer splits each batch over
        # the ranks and the planner's decode its samples
        self.mesh = mesh
        if mesh is not None:
            n = mesh.size
            if cfg.batch_size % n or cfg.num_target_samples % n:
                raise ValueError(
                    f"batch_size ({cfg.batch_size}) and num_target_samples "
                    f"({cfg.num_target_samples}) must divide the mesh size {n}")
            if mesh.device.type != self.device.type:
                raise ValueError(f"the mesh's tensors live on {mesh.device}, the "
                                 f"experiment's on {self.device}")
        if self.device.type == "cuda":
            # float32 math runs in full float32 on the card: cuDNN would
            # otherwise run f32 convs in TF32 (matmuls are f32 by default)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.train_calls_per_tick = train_calls_per_tick
        self.train_every = train_every
        self.scene = scene
        dev = self.device
        states = cfg.states
        self.explored = ExploredStates(cfg, states, dev)
        # the ring's columns as a device index, built once: a Python list
        # index is a blocking copy from pageable memory at every use
        self._state_idx = torch.arange(cfg.s_dim, device=dev)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)

        # as in the JAX Experiment: no angle scale or shift, so an xyzrpw
        # planner wraps its robot-coordinate roll into [0, 2pi)
        self.dyn = make_dynamics(states, dt=cfg.dt, device=dev)
        kcfg = KlergConfig(
            horizon=cfg.horizon, num_target_samples=cfg.num_target_samples,
            num_traj_samples=cfg.num_traj_samples, dt=cfg.dt, R=cfg.R, std=cfg.std,
            uniform_tdist="unif" in cfg.explr_method,
            vel_smoothing=0.5,  # the simulator's smoothing
        )
        self.planner = KlergPlanner(
            kcfg, self.dyn, make_policy("Roll", self.dyn, cfg.horizon), self._pdf,
            states, explr_locs=list(range(len(states))), device=dev)
        # the baseline explorers: every method that is not a *klerg one
        self.use_baseline = "klerg" not in cfg.explr_method
        if self.use_baseline:
            self.baseline = BaselineController(
                cfg.explr_method, cfg.dt, cfg.robot_lim, cfg.robot_ctrl_lim,
                buffer_capacity=cfg.traj_buffer_capacity, device=dev)
        self.trainer = TrainerStatics(
            batch_size=cfg.batch_size, num_learning_opt=cfg.num_learning_opt,
            gamma_weight=cfg.gamma_weight, other_locs=cfg.other_locs,
            lr=cfg.model_lr)
        # captured CUDA graphs on the card, over no mesh or an NCCL one: the
        # whole tick and the post-training call, one memory pool between
        # them (which the host loop's step graphs share). A gloo group's
        # collectives run through the host and cannot be captured: over a
        # gloo mesh (the caller's backend choice) the experiment runs
        # eagerly, as on the CPU.
        self.eager_reason = ("the CPU" if self.device.type != "cuda" else
                             f"a {mesh.backend} mesh" if mesh is not None
                             and mesh.backend != "nccl" else None)
        graphs = self.eager_reason is None
        self.graph_pool = torch.cuda.MemPool() if graphs else None
        self.tick_graph = StepGraph(pool=self.graph_pool) if graphs else None
        self.post_train_graph = StepGraph(pool=self.graph_pool) if graphs else None
        self._host = None  # HostValues, made on the first captured step

        self.tray6 = tuple(TRAY_LIM[s] for s in "xyzrpw")
        if cfg.sim_backend in ("arm", "arm-dynamic", "arm-dynamic-soft"):
            self.env = ArmEnv(tray_lim=self.tray6, dt=cfg.dt / 5.0, img_hw=cfg.image_dim[:2],
                              dynamic_contact=cfg.sim_backend.startswith("arm-dynamic"),
                              soft_objects=cfg.sim_backend == "arm-dynamic-soft",
                              obj_mobility=cfg.obj_mobility, device=str(dev))
        else:
            self.env = SyntheticEnv(tray_lim=self.tray6, dt=cfg.dt / 5.0,
                                    img_hw=cfg.image_dim[:2], device=str(dev))
        self.robot_lim = self.explored.robot_lim
        self.robot_ctrl_lim = self.explored.robot_ctrl_lim

    def _pdf(self, ctx, samples):
        """The planner's target decode; over a mesh (and not under the
        z-ensemble, as in the JAX package) each rank decodes its slice."""
        model, mstate = ctx
        if self.mesh is not None and not self.cfg.use_z_ensemble:
            from ..parallel.train import sharded_pdf
            return sharded_pdf(model, self.mesh, mstate, samples)
        return model.pdf(mstate, samples, use_z_ensemble=self.cfg.use_z_ensemble)

    def make_model(self) -> CVAE:
        cfg = self.cfg
        return CVAE(
            img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
            hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
            cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels,
            y_logvar_dim=cfg.y_logvar_dim, learn_force=cfg.learn_force, dx=cfg.dx,
            compute_dtype=self.compute_dtype, decoder_mode=cfg.decoder_mode,
            fast_encoder_grads=cfg.fast_encoder_grads, lane_pad=cfg.lane_pad)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0, start_tray_pose=None) -> ExperimentState:
        """Random weights from ``seed`` (drawn on the CPU, so every device
        starts from the same model); runtime draws from device generators
        seeded with ``seed`` (trainer) and ``seed + 1`` (planner). The robot
        starts at the 6-D ``start_tray_pose`` (default: the tray's center)."""
        cfg, dev = self.cfg, self.device
        model = self.make_model()
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(dev)
        barrier, _ = setup_barrier(cfg.states, self.robot_lim,
                                   self.robot_ctrl_lim, list(range(cfg.s_dim)))
        if start_tray_pose is None:
            start_tray_pose = [(lo + hi) / 2 for lo, hi in self.tray6]
        start = torch.as_tensor(start_tray_pose, dtype=torch.float32, device=dev)
        x0r = self.explored.start(start)
        if self.use_baseline:
            pstate = self.baseline.init_state(x0r, seed=seed + 1)
        else:
            pstate = self.planner.init_state(
                torch.cat([x0r, torch.zeros_like(x0r)]), self.robot_lim, barrier,
                buffer_capacity=cfg.traj_buffer_capacity,
                explr_lim_scale=cfg.explr_robot_lim_scale, seed=seed + 1)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return ExperimentState(
            model=model, opt=self.trainer.make_optimizer(model),
            mstate=init_model_state(model, dev), pstate=pstate,
            buf=ReplayBuffer.create(cfg.buffer_capacity, cfg.s_dim, cfg.image_dim,
                                    dev, img_dtype=self.compute_dtype),
            env=self.env.init(start, scene=self.scene),
            hyper=HyperState.create(dev), gen=gen)

    # ------------------------------------------------------------------
    def _measured_robot_state(self, env: EnvState | ArmState):
        """(pose, vel) tray -> robot coords over the explored states."""
        return self.explored.measured(env)

    def graphs(self) -> list:
        """The experiment's captured steps, the tick and the post-training
        call (none on the CPU or over a gloo mesh)."""
        return [g for g in (self.tick_graph, self.post_train_graph) if g is not None]

    def plan_step(self, es: ExperimentState, full_state, draws: TickDraws | None = None):
        """Sync the planner (or the baseline) to the measured state, plan
        (or step), and convert the predicted state to a tray-frame 6-twist
        and a brightness command. Returns (pstate, vel6, b_cmd or None,
        info)."""
        m = self.dyn.num_actions
        if self.use_baseline:
            pstate = self.baseline.save_update(es.pstate, full_state, save=True)
            pstate, x_pred, vel_pred = self.baseline.step(
                pstate, draws.baseline if draws else None)
            info = {"cost": torch.zeros((), device=self.device)}
        else:
            pstate = self.planner.save_update(es.pstate, full_state, save=True)
            pstate, info = self.planner.plan(
                pstate, (es.model, es.mstate),
                use_prior=es.explr_step < self.cfg.prior_steps,
                samples=draws.samples if draws else None,
                hist_idx=draws.hist_idx if draws else None)
            x_pred = self.dyn.step(pstate.dyn, pstate.u[0]).x
            vel_pred = x_pred[m:]
        tracing.begin("env")
        vel6, b_cmd = self.explored.command(x_pred[:m], vel_pred)
        return pstate, vel6, b_cmd, info

    def tick(self, es: ExperimentState, draws: TickDraws | None = None):
        """One exploration step plus throttled learning, through the tick
        graph where the experiment has one. Returns (es, tick_info); ``es``
        is updated in place."""
        with tracing.tick():
            if self.tick_graph is None:
                return self._tick(es, draws)
            return self._graph_tick(es, draws)

    def _tick(self, es: ExperimentState, draws: TickDraws | None = None,
              host: HostValues | None = None):
        """The tick's body; ``host`` stages the host values. The tracer's
        device spans: ``tick`` over the body, ``env`` from the command
        (``plan_step``) to the render."""
        tracing.begin("tick")
        full_state = self._measured_robot_state(es.env)
        pstate, vel6, b_cmd, info = self.plan_step(es, full_state, draws)
        env = es.env
        for _ in range(self.cfg.data_to_ctrl_rate):
            env = self.env.step_vel(env, vel6, b_cmd)
        _, _, force, img = self.env.observe(env)
        tracing.end("env")
        robot_state = self._measured_robot_state(env)[: self.cfg.s_dim]
        es.env = env
        out = self.absorb_step(es, pstate, info, robot_state, img, force, draws, host=host)
        tracing.end("tick")
        return out

    def _throttle(self, explr_step: int, learning_ind: int) -> tuple:
        """Which of the tick's ``train_calls_per_tick`` trainer calls run,
        from the host counters at the tick's start."""
        cfg = self.cfg
        out = []
        for _ in range(self.train_calls_per_tick):
            do = (learning_ind < cfg.target_learning_rate * (explr_step + 1
                                                            - cfg.frames_before_training)
                  and explr_step + 1 >= cfg.frames_before_training)
            if self.train_every > 1:
                do = do and explr_step % self.train_every == 0
            out.append(bool(do))
            learning_ind += do
        return tuple(out)

    def absorb_step(self, es: ExperimentState, pstate, info, robot_state, img,
                    force, draws: TickDraws | None = None, host: HostValues | None = None):
        """Push the sample, reseed the target distribution, update the
        hyperparameters and run the throttled learning: the tracer's device
        span ``absorb``, the trainer calls' ``train`` spans inside it."""
        tracing.begin("absorb")
        cfg = self.cfg
        force = force.float().reshape(-1)
        if force.shape[0] > 1:
            force = torch.linalg.norm(force)[None]
        if cfg.image_dim[2] == 1 and img.shape[-1] != 1:
            img = img.mean(-1, keepdim=True)
        es.buf.push(robot_state, img, force)
        es.mstate, _ = update_dist(es.model, es.mstate, robot_state, img,
                                   force if cfg.learn_force else None)
        es.pstate = pstate
        # the grade folds the planner's own decode only where that decode is
        # the plain pdf: not under the z-ensemble, and a baseline decodes none
        fold = (cfg.hyper_from_planner and not self.use_baseline
                and not cfg.use_z_ensemble
                and "tdist_pdf" in info and "tdist_spread" in info)

        metrics = None
        for i, do in enumerate(self._throttle(es.explr_step, es.learning_ind)):
            if not do:
                # a skipped call reports zero metrics and pushes no grade
                metrics = None
                continue
            if fold:
                # reuse the planner's pdf decode and coverage of this tick
                spread = info["tdist_spread"]
                grade = entropy_grade(info["tdist_pdf"], spread, cfg.xi)
            else:
                grade, spread = self._grade_spread(
                    es, draws.grade_samples[i] if draws and draws.grade_samples else None)
            metrics = self._hyper_and_train(es, grade, spread,
                                            draws.train[i] if draws and draws.train else None,
                                            host=host, slot=i)

        es.explr_step += 1
        zero = torch.zeros((), device=self.device)
        tick_info = {
            "ergodic_cost": info["cost"],
            "loss": metrics["loss"][-1] if metrics is not None else zero,
            "beta": es.hyper.beta,
            "gamma": es.hyper.gamma,
            "robot_state": robot_state,
            "force": force,
        }
        tracing.end("absorb")
        return es, tick_info

    def _grade_spread(self, es: ExperimentState, samples=None):
        """Entropy grade and coverage spread from a fresh pdf decode at
        ``samples`` (drawn uniformly from ``es.gen`` unless fed) and the
        replay ring's poses."""
        cfg = self.cfg
        if samples is None:
            lo, hi = self.robot_lim[:, 0], self.robot_lim[:, 1]
            samples = torch.rand((cfg.num_target_samples, cfg.s_dim),
                                 generator=es.gen, device=self.device) * (hi - lo) + lo
        pdf_vals = es.model.pdf(es.mstate, samples)
        all_x, x_mask = es.buf.get_all_x()
        return entropy_grade_spread(
            pdf_vals, all_x, x_mask, samples, self._state_idx,
            torch.full((cfg.s_dim,), cfg.std, device=self.device), cfg.xi)

    def _hyper_and_train(self, es: ExperimentState, grade, spread,
                         train_draws: TrainDraws | None, host: HostValues | None = None,
                         slot: int = 0):
        """Update beta/gamma, make one trainer call (data-parallel over the
        mesh, if any), push (grade, spread) to the hyperparameter ring and
        count the call. ``host`` stages the step and the manual ramps of
        trainer-call ``slot``. Returns the metrics."""
        cfg = self.cfg
        hyper = hyperparam_update(
            es.hyper, grade, spread,
            fixed_beta=cfg.fixed_beta, beta_manual_ramp=cfg.beta_manual_ramp,
            fixed_gamma=cfg.fixed_gamma, gamma_manual_ramp=cfg.gamma_manual_ramp,
            other_locs=cfg.other_locs,
            beta_start=cfg.beta_start_weight, beta_end=cfg.beta_end_weight,
            beta_warmup_steps=cfg.beta_warmup_steps,
            beta_warmup_epoch=cfg.beta_warmup_epoch,
            gamma_start=cfg.gamma_start_weight, gamma_end=cfg.gamma_end_weight,
            gamma_warmup_steps=cfg.gamma_warmup_steps,
            gamma_warmup_epoch=cfg.gamma_warmup_epoch,
            ramp=None if host is None else host.ramp(slot))
        hyper.iter += self.trainer.num_learning_opt
        es.hyper = hyper
        tracing.begin("train")
        if self.mesh is not None:
            from ..parallel.train import dp_train_call
            metrics = dp_train_call(self.trainer, self.mesh, es.model, es.opt, es.buf,
                                    hyper.beta, hyper.gamma, generator=es.gen,
                                    draws=train_draws)
        else:
            metrics = train_call(self.trainer, es.model, es.opt, es.buf, hyper.beta,
                                 hyper.gamma, generator=es.gen, draws=train_draws)
        tracing.end("train")
        es.buf.update_hyperparams(es.explr_step if host is None else host.explr_step,
                                  grade, spread)
        es.learning_ind += 1
        return metrics

    def run_chunk(self, es: ExperimentState, n_steps: int,
                  draws: list[TickDraws] | None = None):
        """n ticks (each through the tick graph where the experiment has
        one); ``draws`` feeds each tick's draws. Returns (es, infos stacked
        over the ticks)."""
        infos = [self.tick(es, draws[i] if draws else None)[1] for i in range(n_steps)]
        return es, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}

    def post_train_chunk(self, es: ExperimentState, n_calls: int,
                         draws: list[PostTrainDraws] | None = None):
        """n trainer calls with no exploration: the post-exploration
        training phase (port of ``Experiment.post_train_chunk`` of the JAX
        package), each through the post-training graph where the
        experiment has one. Each call grades the model's entropy at fresh
        uniform samples over the frozen replay ring, updates beta/gamma and
        trains. ``draws`` feeds each call's samples and trainer draws.
        Returns (es, infos): the last loss, beta and gamma of each call,
        stacked."""
        rows = []
        for c in range(n_calls):
            d = draws[c] if draws else None
            if self.post_train_graph is None:
                rows.append(self._post_train_call(es, d))
            else:
                rows.append(self._graph_post_train(es, d))
        return es, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def _post_train_call(self, es: ExperimentState, d: PostTrainDraws | None,
                         host: HostValues | None = None):
        grade, spread = self._grade_spread(es, d.samples if d else None)
        metrics = self._hyper_and_train(es, grade, spread, d.train if d else None, host=host)
        return {"loss": metrics["loss"][-1], "beta": es.hyper.beta, "gamma": es.hyper.gamma}

    # ------------------------------------------------------------------
    # the tick and the post-training call as captured steps
    def _tick_pattern(self, es: ExperimentState) -> tuple:
        """The host values the tick branches on: which trainer calls run,
        whether the target is the prior, and which of its velocity commands
        correct the arm's drift."""
        return (self._throttle(es.explr_step, es.learning_ind),
                es.explr_step < self.cfg.prior_steps,
                drift_key(self.env, es.env, self.cfg.data_to_ctrl_rate))

    def _stage(self, es: ExperimentState, do: tuple) -> HostValues:
        """Fill the staged host values for a step from ``es``: the step, and
        each running trainer call's manual ramps."""
        cfg = self.cfg
        if self._host is None:
            self._host = HostValues.create(self.train_calls_per_tick, self.device)
        host = self._host
        host.explr_step.fill_(es.explr_step)
        if cfg.beta_manual_ramp or cfg.gamma_manual_ramp:
            it = es.hyper.iter
            for slot, run in enumerate(do):
                if not run:
                    continue
                host.beta[slot].fill_(manual_ramp(it, cfg.beta_start_weight,
                                                  cfg.beta_end_weight, cfg.beta_warmup_steps,
                                                  cfg.beta_warmup_epoch))
                host.gamma[slot].fill_(manual_ramp(it, cfg.gamma_start_weight,
                                                   cfg.gamma_end_weight,
                                                   cfg.gamma_warmup_steps,
                                                   cfg.gamma_warmup_epoch))
                it += self.trainer.num_learning_opt
        return host

    def _base(self, es: ExperimentState, carry) -> tuple:
        """What a captured step reads in place, by address: the model's
        parameters and buffers, the optimizer's state, the replay ring's
        rows and counters, the planner's (or baseline's) tensors; with the
        generators, the trainer's statics and the carry's structure."""
        owner = self.baseline if self.use_baseline else self.planner
        ring = [getattr(es.buf, f.name) for f in dataclasses.fields(es.buf)]
        return step_base(owner, (es.gen, es.pstate.gen), carry, id(self.cfg), self.trainer,
                         module_key(es.model), optimizer_key(es.opt), _addresses(ring))

    @staticmethod
    def _carry(es: ExperimentState) -> tuple:
        """What a tick replaces: the planner's (or baseline's) state and
        the env's (``sim_carry``), the target state, beta and gamma."""
        return (*sim_carry(es.pstate, es.env), es.mstate, es.hyper.beta, es.hyper.gamma)

    @staticmethod
    def _with_carry(es: ExperimentState, carry) -> ExperimentState:
        """A view of ``es`` holding ``carry``, with ``es``'s host ints."""
        pstate, env = with_sim_carry(es.pstate, es.env, carry[:2])
        mstate, beta, gamma = carry[2:]
        return dataclasses.replace(es, pstate=pstate, env=env, mstate=mstate,
                                   hyper=dataclasses.replace(es.hyper, beta=beta, gamma=gamma))

    def _graph_step(self, step_graph: StepGraph, es: ExperimentState, pattern, draws, run,
                    calls: int):
        """One step through ``step_graph`` (``graphs.run_step``): the
        pattern's first step runs eagerly, its second captures, later ones
        replay. ``run(view, draws)`` makes the step on a view of ``es`` and
        returns its out. Then ``es`` takes the new carry and its host ints
        advance by the step's ``calls`` trainer calls. Returns out."""
        view, out = run_step(step_graph, es, self._carry, self._with_carry, self._base, pattern,
                             draws, lambda view, d: (view, run(view, d)),
                             [es.gen, es.pstate.gen])
        self._take(es, view, calls)
        return out

    def _take(self, es: ExperimentState, view: ExperimentState, calls: int) -> None:
        """``es`` takes a captured step's new carry from ``view``, and its
        host ints advance by the step's ``calls`` trainer calls (the caller
        advances ``explr_step``)."""
        es.pstate, es.env, es.mstate = view.pstate, view.env, view.mstate
        es.hyper = dataclasses.replace(view.hyper, iter=es.hyper.iter
                                       + calls * self.trainer.num_learning_opt)
        es.learning_ind += calls

    def _graph_tick(self, es: ExperimentState, draws: TickDraws | None):
        """``tick`` through the tick graph."""
        pattern = self._tick_pattern(es)
        host = self._stage(es, pattern[0])
        info = self._graph_step(
            self.tick_graph, es, pattern, draws,
            lambda view, d: self._tick(view, d, host=host)[1], sum(pattern[0]))
        es.env = advance_env(es.env, self.cfg.data_to_ctrl_rate)
        es.explr_step += 1
        return es, info

    def _graph_post_train(self, es: ExperimentState, d: PostTrainDraws | None):
        """One post-training call through the post-training graph (one
        pattern: the call branches on no host value)."""
        host = self._stage(es, (True,))
        return self._graph_step(
            self.post_train_graph, es, (), d,
            lambda view, d: self._post_train_call(view, d, host=host), 1)

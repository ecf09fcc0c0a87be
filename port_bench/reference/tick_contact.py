"""One explore-and-learn tick on the contact arm with the force
sensor-object model, recomputed in plain torch from the state before it:
``tick.py``'s learning tick as the port's ``Experiment`` makes it with
``learn_force``, ``use_z_ensemble`` and ``sim_backend="arm-dynamic"``.

What differs from ``tick.py``:

- the plant is the 7-DoF arm with penalty contact (``arm.py``) on the
  configuration's scene; the observed contact wrench (3,) is reduced to
  the learned 1-D |F|, which the ring stores and the encoder reads;
- the CVAE is ``cvae_force.ForceCVAE``: the planner's target decodes its
  samples under every latent of the z ring (``use_z_ensemble``), the
  reseeding reads the force, and each trainer step encodes and targets
  the sampled forces (the cross-decode draw's forces its second target);
- the trainer call's entropy grade cannot fold the planner's decode, an
  ensemble's (``Experiment.absorb_step``): a fresh plain decode of
  ``num_target_samples`` uniform poses drawn from the trainer's generator
  first, and the coverage spread of the ring's poses in K1's arithmetic
  (``Experiment._grade_spread``), give beta and gamma.

Two planted faults besides ``tick.py``'s: ``force_dropped``, each trainer
step encodes and targets zero force; ``ensemble_collapsed``, the planner
decodes under the newest latent only.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cvae as cvae_mod
from . import cvae_force
from .arm import ArmEnv, ArmState
from .kernels import traj_spread
from .losses import cvae_loss
from .renderer import TrayScene
from .replay import ReplayBuffer
from .tick import TRAY6, Tick, throttle


def entropy_grade(pdf_vals, spread, xi: float):
    """The clamped inverse least normalised entropy under exponent ``xi``."""
    ent = pdf_vals ** spread
    ent = ent / ent.max().clamp(min=1e-30)
    return torch.pow(10.0, -torch.log10(ent.min().clamp(min=1e-30)) - xi).clamp(max=0.01)


def contact_scene(spec: dict, device) -> TrayScene:
    """The default tray scene with the objects' radii and heights of
    ``spec`` ({"obj_radius": [...], "obj_height": [...]})."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return TrayScene.default(device)._replace(obj_radius=t(spec["obj_radius"]),
                                              obj_height=t(spec["obj_height"]))


class ContactTick(Tick):
    """The pieces of a learning tick on the arm for one configuration."""

    def __init__(self, cfg, device, scene: dict, cast=cvae_mod.no_cast,
                 ring_cast=cvae_mod.no_cast, half_batch: bool = False, stuck: bool = False,
                 force_dropped: bool = False, ensemble_collapsed: bool = False):
        if (cfg.sim_backend, cfg.learn_force, cfg.use_z_ensemble) != ("arm-dynamic", True, True):
            raise NotImplementedError("the contact tick covers learn_force and use_z_ensemble "
                                      "on 'arm-dynamic' only")
        device = torch.device(device)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # tick.py's pieces, built for the free env whose place the arm takes
        super().__init__(dataclasses.replace(cfg, sim_backend="free", learn_force=False,
                                             use_z_ensemble=False, hyper_from_planner=True),
                         device, True, cast, ring_cast, half_batch, stuck)
        self.cfg = cfg
        self.force_dropped = force_dropped
        self.ensemble = not ensemble_collapsed
        self.arm = ArmEnv(tray_lim=TRAY6, dt=cfg.dt / 5.0, img_hw=cfg.image_dim[:2],
                          obj_mobility=cfg.obj_mobility, device=str(device))
        self.scene = contact_scene(scene, device)

    def make_model(self, seed=None) -> cvae_force.ForceCVAE:
        cfg = self.cfg
        model = cvae_force.ForceCVAE(
            img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
            hidden_dim=cfg.model_hidden(), cnn_kernels=cfg.cnn_kernels,
            cnn_strides=cfg.cnn_strides, cnn_channels=cfg.cnn_channels,
            y_logvar_dim=cfg.y_logvar_dim, cast=self.cast, ensemble=self.ensemble)
        if seed is not None:
            model.reset_parameters(torch.Generator().manual_seed(seed))
        return model.to(self.device)

    def arm_state(self, snap: dict) -> ArmState:
        return ArmState(q=snap["q"], qdot=snap["qdot"], pose=snap["pose"], vel=snap["vel"],
                        brightness=snap["brightness"], count=snap["arm_count"],
                        scene=self.scene)

    def explore(self, snap, pdf_ctx, u=None):
        """``Tick.explore`` on the arm: the force returned is the wrench (3,)."""
        env = self.arm_state(snap)
        pstate = self.planner.save_update(self._pstate(snap), self.ex.measured(env), save=True)
        pstate, info = self.planner.plan(pstate, pdf_ctx)
        m = self.dyn.num_actions
        x_pred = self.dyn.step(pstate.dyn, (pstate.u if u is None else u)[0]).x
        env = self.arm.step_vel(env, self.ex.command(x_pred[m:]))
        _, _, force, img = self.arm.observe(env)
        return pstate.u, info, env, self.ex.measured(env)[: self.cfg.s_dim], img, force

    def stuck_tick(self, snap) -> dict:
        """``Tick.stuck_tick`` on the arm: the state, latents, joints and
        force before the tick, no ring row, no cost, no trainer call."""
        env = self.arm_state(snap)
        _, _, force, img = self.arm.observe(env)
        return dict(cost=torch.zeros((), device=self.device), u=snap["u"],
                    robot_state=self.ex.measured(env)[: self.cfg.s_dim],
                    image=torch.zeros_like(img), z=snap["z_buff"], q=snap["q"],
                    force=torch.linalg.vector_norm(force.float()).reshape(1))

    def learn_tick(self, snap, ring_y, train_every: int, u=None) -> dict:
        """One explore-and-learn tick on the arm (``u`` as in
        ``Tick.explore``). Returns, besides ``Tick.learn_tick``'s, the
        force pushed and the joints after the tick; ``z`` is the whole z
        ring."""
        if self.stuck:
            return self.stuck_tick(snap)
        cfg, dev = self.cfg, self.device
        model = self.make_model()
        model.load_state_dict(snap["params"])
        mstate = cvae_mod.ModelState(*(snap[k] for k in (
            "seed_x", "seed_y", "seed_force", "z", "z_buff", "initialized")))
        plan, info, env, robot_state, img, wrench = self.explore(snap, (model, mstate), u)
        force = wrench.float().reshape(-1)
        if force.shape[0] > 1:
            force = torch.linalg.norm(force)[None]
        ring = self._ring(snap, ring_y)
        pushed = self.ring_cast(img)
        ring.push(robot_state, pushed, force)
        mstate = cvae_force.update_dist(model, mstate, robot_state, img, force)
        out = dict(cost=info["cost"], robot_state=robot_state, image=pushed, u=plan,
                   z=mstate.z_buff, force=force, q=env.q)
        if not throttle(cfg, snap["explr_step"], snap["learning_ind"], train_every):
            return out
        gen = torch.Generator(device=dev)
        gen.set_state(snap["trainer_gen"])
        grade, spread = self.grade_spread(model, mstate, ring, gen)
        out.update(self.train_call(model, snap, ring, grade.float(), spread.float(), gen),
                   beta=grade.float(), gamma=spread.float())
        return out

    def _ring(self, snap, ring_y) -> ReplayBuffer:
        """The ring before the tick: the snapshot's rows and counters, the
        program's images."""
        dev, zero = self.device, snap["ring_pos"] * 0
        return ReplayBuffer(x=snap["ring_x"].clone(), y=ring_y.float(),
                            force=snap["ring_force"].clone(), y_var=snap["ring_y_var"].clone(),
                            beta=torch.zeros(1, device=dev), gamma=torch.zeros(1, device=dev),
                            beta_pos=zero, beta_size=zero, explr_ind=zero,
                            pos=snap["ring_pos"].clone(), size=snap["ring_size"].clone(),
                            total=snap["ring_total"].clone())

    def grade_spread(self, model, mstate, ring, gen) -> tuple:
        """(grade, spread) from a plain decode at ``num_target_samples``
        uniform poses drawn from ``gen`` and the coverage of the ring's
        poses."""
        cfg, dev = self.cfg, self.device
        lo, hi = self.ex.robot_lim[:, 0], self.ex.robot_lim[:, 1]
        samples = torch.rand((cfg.num_target_samples, cfg.s_dim), generator=gen,
                             device=dev) * (hi - lo) + lo
        pdf_vals = model.pdf(mstate, samples, ensemble=False)
        all_x, x_mask = ring.get_all_x()
        max_q = traj_spread(all_x, samples, torch.arange(cfg.s_dim, device=dev),
                            torch.full((cfg.s_dim,), cfg.std, device=dev), traj_mask=x_mask)
        max_q = max_q / max_q.max().clamp(min=1e-30)
        spread = torch.where(x_mask.sum() > 0, max_q.mean(), torch.zeros_like(max_q[0]))
        return entropy_grade(pdf_vals, spread, cfg.xi), spread

    def train_call(self, model, snap, ring, beta, gamma, gen) -> dict:
        """``Tick.train_call`` with the sampled forces as the encoder's
        input and the force head's targets (zeros under
        ``force_dropped``)."""
        cfg = self.cfg
        B = cfg.batch_size
        names = [n for n, _ in model.named_parameters()]
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
            x, y, force, force2 = ring.x[idx], ring.y[idx], ring.force[idx], ring.force[idx2]
            if self.force_dropped:
                force, force2 = torch.zeros_like(force), torch.zeros_like(force2)
            out = model(x, y, force, x_decode=ring.x[idx2], train=True, generator=gen)
            loss, _ = cvae_loss(out, y, y2=ring.y[idx2], beta=beta, gamma=gamma,
                                gamma_weight=cfg.gamma_weight, other_locs=True, force=force,
                                force2=force2, learn_force=True)
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

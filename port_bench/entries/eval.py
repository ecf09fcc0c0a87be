"""``EvalExperiment.tick`` toward the pdf of a CVAE frozen at its seed
weights, its latent seeded from the camera at the start pose, from a fresh
history: the exploration step of the fingerprint stage, with no
trainer."""

from __future__ import annotations

from ..drive import Driver, env_snapshot, params, planner_snapshot
from ..reference.tick import Tick


class Entry(Driver):
    learning = False
    checked = ("cost",)

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        import torch
        from ealv_tpu_torch.models import CVAE, init_model_state, update_dist
        from ealv_tpu_torch.runtime import EvalExperiment
        c = self.cfg
        self.exp = EvalExperiment(c, pdf_fn=lambda ctx, s: ctx[0].pdf(ctx[1], s),
                                  device=device)
        model = CVAE(img_dim=c.image_dim, z_dim=c.z_dim, s_dim=c.s_dim,
                     hidden_dim=c.model_hidden(), cnn_kernels=c.cnn_kernels,
                     cnn_strides=c.cnn_strides, cnn_channels=c.cnn_channels,
                     y_logvar_dim=c.y_logvar_dim, compute_dtype=getattr(torch, c.compute_dtype),
                     decoder_mode=c.decoder_mode)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(self.device)
        self.start = params(model)
        self.ev = self.exp.init(seed=seed)
        _, _, _, img = self.exp.env.observe(self.ev.env)
        robot = self.exp.explored.measured(self.ev.env)[: c.s_dim]
        mstate, _ = update_dist(model, init_model_state(model, self.device), robot, img)
        self.ctx = (model, mstate)
        self.graph = self.exp.tick_graph

    def tick(self) -> dict:
        self.ev, obs = self.exp.tick(self.ev, self.ctx)
        return obs

    def fill(self) -> int:
        return int(self.ev.pstate.memory.size)

    def snapshot(self) -> dict:
        return dict(**planner_snapshot(self.ev.pstate), **env_snapshot(self.ev.env))

    def outputs(self, snap: dict, info: dict) -> dict:
        return dict(cost=info["cost"], robot_state=info["robot_state"], image=info["image"],
                    u=self.ev.pstate.u.clone(), trained=False)

    def free(self) -> None:
        self.exp = self.ev = self.ctx = self.graph = None

    def target(self, tick: Tick):
        return tick.eval_target(self.seed)

    def recompute(self, tick: Tick, target, snap: dict, ring_y, u=None) -> dict:
        return tick.eval_tick(snap, *target, u)

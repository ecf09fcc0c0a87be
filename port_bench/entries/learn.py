"""``Experiment.tick``, explore and learn, from a fresh
``Experiment.init(seed)``: the trainer throttle's ``train_calls_per_tick``
and ``train_every`` come from the traffic file."""

from __future__ import annotations

import torch

from ..drive import Driver, env_snapshot, params, planner_snapshot
from ..reference.tick import Tick, throttle


class Entry(Driver):
    learning = True
    checked = ("ergodic_cost", "loss")

    def __init__(self, cfg, traffic, seed, device):
        super().__init__(cfg, traffic, seed, device)
        from ealv_tpu_torch.runtime import Experiment
        self.exp = Experiment(self.cfg, train_calls_per_tick=traffic["train_calls_per_tick"],
                              train_every=traffic["train_every"], device=device)
        self.es = self.exp.init(seed)
        self.start = params(self.es.model)
        self.graph = self.exp.tick_graph

    def tick(self) -> dict:
        before = self.es.learning_ind
        _, info = self.exp.tick(self.es)
        self.trained = self.es.learning_ind > before
        return info

    def fill(self) -> int:
        return int(self.es.pstate.memory.size)

    def will_train(self) -> bool:
        return throttle(self.cfg, self.es.explr_step, self.es.learning_ind,
                        self.traffic["train_every"])

    def snapshot(self) -> dict:
        es = self.es
        now = params(es.model)
        state = {n: es.opt.state.get(p, {}) for n, p in es.model.named_parameters()}
        zeros = {n: torch.zeros_like(p) for n, p in now.items()}
        ms = es.mstate
        return dict(
            **planner_snapshot(es.pstate), **env_snapshot(es.env),
            seed_x=ms.seed_x.clone(), seed_y=ms.seed_y.clone(),
            seed_force=ms.seed_force.clone(), z=ms.z.clone(), z_buff=ms.z_buff.clone(),
            initialized=ms.initialized.clone(), params=now,
            exp_avg={n: s["exp_avg"].clone() if s else zeros[n] for n, s in state.items()},
            exp_avg_sq={n: s["exp_avg_sq"].clone() if s else zeros[n]
                        for n, s in state.items()},
            step={n: s["step"].clone() if s else torch.zeros(()) for n, s in state.items()},
            ring_x=es.buf.x.clone(), ring_force=es.buf.force.clone(),
            ring_y_var=es.buf.y_var.clone(), ring_pos=es.buf.pos.clone(),
            ring_size=es.buf.size.clone(), ring_total=es.buf.total.clone(),
            trainer_gen=es.gen.get_state(), explr_step=es.explr_step,
            learning_ind=es.learning_ind)

    def outputs(self, snap: dict, info: dict) -> dict:
        """What the tick after ``snap`` produced; the pushed image is read
        from the ring once the window has closed (``ring_images``)."""
        es = self.es
        out = dict(cost=info["ergodic_cost"], robot_state=info["robot_state"],
                   u=es.pstate.u.clone(), z=es.mstate.z.clone(), trained=self.trained)
        if self.trained:
            out.update(loss=info["loss"], beta=info["beta"], gamma=info["gamma"],
                       params=params(es.model),
                       exp_avg={n: es.opt.state[p]["exp_avg"].clone()
                                for n, p in es.model.named_parameters()},
                       exp_avg_sq={n: es.opt.state[p]["exp_avg_sq"].clone()
                                   for n, p in es.model.named_parameters()})
        return out

    def ring_images(self):
        """The ring's images, kept while the rest of the program's state is
        freed (the ring never wraps in a run: ``num_steps`` is below its
        capacity, so a row holds what its tick pushed)."""
        return self.es.buf.y

    def free(self) -> None:
        self.exp = self.es = self.graph = None

    def recompute(self, tick: Tick, target, snap: dict, ring_y, u=None) -> dict:
        return tick.learn_tick(snap, ring_y, self.traffic["train_every"], u)

"""``Experiment.tick``, explore and learn, on the contact arm: ``learn``'s
entry with the configuration's scene (its ``config["scene"]``, the
objects' radii and heights, taken out before the rest builds the
program's ``ExperimentConfig``) and, where the traffic gives one, its
``start`` (the tray position x, y, z the arm starts from; else the tray's
centre). The reference is ``reference/tick_contact.py``.

Besides ``learn``'s, a compared tick reads the whole z ring as its
latent, the 1-D |F| it pushed to the ring (``force``) and the arm's joints
(``joints``). ``FAULTS`` are the two planted faults of this entry that
``python3 -m port_bench.readings_contact`` runs beside
``harness.CONTROLS``.
"""

from __future__ import annotations

import torch

from ..drive import Driver, params, reference_config
from ..reference import cvae as ref_cvae
from ..reference.tick import throttle
from ..reference.tick_contact import ContactTick
from . import learn

FAULTS = {"force_dropped": dict(force_dropped=True),
          "ensemble_collapsed": dict(ensemble_collapsed=True)}
# a force gap is taken relative to the larger of the reference's |F| and
# a thousandth of the arm's 30 N clip, so a contact that a last place opens
# or closes reads as the small force it is
FORCE_FLOOR = 0.03


def _rel(a, b, floor: float = 1e-30) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=floor))


class Entry(learn.Entry):
    def __init__(self, cfg, traffic, seed, device):
        self.scene_spec = cfg["scene"]
        Driver.__init__(self, {k: v for k, v in cfg.items() if k != "scene"}, traffic, seed,
                        device)
        from ealv_tpu_torch.runtime import Experiment
        from ealv_tpu_torch.sim.renderer import TrayScene
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        scene = TrayScene.default(device)._replace(obj_radius=t(self.scene_spec["obj_radius"]),
                                                   obj_height=t(self.scene_spec["obj_height"]))
        self.exp = Experiment(self.cfg, train_calls_per_tick=traffic["train_calls_per_tick"],
                              train_every=traffic["train_every"], scene=scene, device=device)
        start = None
        if "start" in traffic:
            start = [(lo + hi) / 2 for lo, hi in self.exp.tray6]
            start[:3] = traffic["start"]
        self.es = self.exp.init(seed, start_tray_pose=start)
        self.start = params(self.es.model)
        self.graph = self.exp.tick_graph

    def snapshot(self) -> dict:
        env = self.es.env
        return dict(super().snapshot(), q=env.q.clone(), qdot=env.qdot.clone(),
                    arm_count=env.count)

    def outputs(self, snap: dict, info: dict) -> dict:
        out = super().outputs(snap, info)
        out.update(z=self.es.mstate.z_buff.clone(), force=info["force"].clone(),
                   q=self.es.env.q.clone())
        return out

    def reference(self, cast=None, ring_cast=None, half_batch: bool = False,
                  stuck: bool = False, force_dropped: bool = False,
                  ensemble_collapsed: bool = False) -> ContactTick:
        stated = ref_cvae.CASTS[self.cfg_dict["compute_dtype"]]
        return ContactTick(reference_config(self.cfg_dict), self.device, self.scene_spec,
                           cast or stated, ring_cast or stated, half_batch, stuck,
                           force_dropped, ensemble_collapsed)

    def extra_gaps(self, prog: dict, ref: dict, snap: dict) -> dict:
        """``force``: the |F| pushed to the ring, relative (``FORCE_FLOOR``);
        ``joints``: the arm's joints after the tick, the largest gap over
        the largest joint of the reference's."""
        return dict(force=_rel(prog["force"], ref["force"], FORCE_FLOOR),
                    joints=_rel(prog["q"], ref["q"]))

    def k1_launches(self, fill: int) -> list:
        """``learn``'s, and on a trainer tick the unfolded grade's coverage
        spread over the ring's poses (``num_target_samples`` x the ring's
        capacity, its fill unmasked). ``fill`` places the tick after the
        current one."""
        out = super().k1_launches(fill)
        cfg = self.cfg
        ahead = fill - self.fill() - 1
        step, ind, every = self.es.explr_step, self.es.learning_ind, self.traffic["train_every"]
        for _ in range(ahead):
            ind += throttle(cfg, step, ind, every)
            step += 1
        if throttle(cfg, step, ind, every):
            cap = cfg.buffer_capacity
            out.append((cfg.num_target_samples, cap, cfg.s_dim,
                        min(int(self.es.buf.size) + ahead + 1, cap)))
        return out

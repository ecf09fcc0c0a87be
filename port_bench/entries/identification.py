"""``FingerprintMatrixRuntime.tick``: fingerprint identification with every
distance combination from one exploration, after adoption.

Set-up follows ``ealv_tpu_torch/scripts/run_fingerprint_matrix.py`` with
no learning phase: the CVAE at the seed's weights, a K-object scene from
the seed (``TrayScene.make``), one fingerprint captured at each true
object centre, each combination's beliefs with thresholds calibrated from
the fingerprints, and the runtime's ``init(seed)``. Set-up then makes the
ticks before adoption (``adopt_step``), so that the warm-up settles on the
adopted tick's pattern and nothing captures inside the window. The
configuration's ``identify`` holds the identification's sizes; it is taken
out before ``ExperimentConfig`` is built, and the set-up's ticks count
against ``num_steps`` with the window's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import counts
from ..drive import Driver, env_snapshot, params, planner_snapshot
from ..reference import identify as ref_identify
from ..reference.tick import Tick

BELIEF_STATE = ref_identify.BELIEF_STATE


def split_config(cfg: dict) -> tuple:
    """(the ``ExperimentConfig`` keys, the identification's sizes)."""
    cfg = dict(cfg)
    return cfg, cfg.pop("identify")


def _stacked(beliefs, name: str):
    """A field of every belief, (C, K, ...): a copy."""
    return torch.stack([torch.stack([getattr(b, name) for b in bs]) for bs in beliefs])


def _rel(a, b) -> float:
    """|a - b| over the largest |b|, the widest; NaN where both are NaN
    reads 0."""
    a, b = a.float(), b.float()
    both = a.isnan() & b.isnan()
    gap = torch.where(both, torch.zeros_like(a), (a - b).abs())
    return float(gap.max() / b.nan_to_num().abs().max().clamp(min=1e-30))


class Entry(Driver):
    learning = False
    checked = ("cost", "dists")

    def __init__(self, cfg, traffic, seed, device):
        cfg, self.ident = split_config(cfg)
        super().__init__(cfg, traffic, seed, device)
        from ealv_tpu_torch.fingerprint.belief import FingerprintBelief
        from ealv_tpu_torch.fingerprint.capture import capture_fingerprint
        from ealv_tpu_torch.fingerprint.identify import FingerprintSet, calibrate_thresholds
        from ealv_tpu_torch.fingerprint.test_runtime import FingerprintMatrixRuntime
        from ealv_tpu_torch.models import CVAE
        from ealv_tpu_torch.sim.renderer import TrayScene
        # the program's per-tick entry: a program without one fails here, before set-up
        FingerprintMatrixRuntime.tick
        c, ident = self.cfg, self.ident
        model = CVAE(img_dim=c.image_dim, z_dim=c.z_dim, s_dim=c.s_dim,
                     hidden_dim=c.model_hidden(), cnn_kernels=c.cnn_kernels,
                     cnn_strides=c.cnn_strides, cnn_channels=c.cnn_channels,
                     y_logvar_dim=c.y_logvar_dim, compute_dtype=getattr(torch, c.compute_dtype),
                     decoder_mode=c.decoder_mode)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model.to(self.device)
        self.start = params(model)
        scene = TrayScene.make(ident["objects"], seed=seed, device=device)
        # the true centres in robot coordinates over the states, the angles at 0
        tl, rl = c.tray_lim, c.robot_lim
        truth = []
        for xy in scene.obj_xy.cpu().numpy():
            full = np.zeros(c.s_dim, np.float32)
            full[0], full[1] = xy
            truth.append(((full - tl[:, 0]) / (tl[:, 1] - tl[:, 0]) * (rl[:, 1] - rl[:, 0])
                          + rl[:, 0]).astype(np.float32))
        fps = FingerprintSet.from_lists(
            [capture_fingerprint(model, c, ctr, scene=scene, num_steps=ident["capture_steps"],
                                 seed=i, device=device) for i, ctr in enumerate(truth)],
            device=device)
        self.fps = {k: getattr(fps, k) for k in ("z_mu", "z_logvar", "x", "center", "mask")}
        combos = tuple((m, bool(e)) for m, e in ident["combos"])
        beliefs = {}
        for m, e in combos:
            thresh, clip = calibrate_thresholds(fps, m)
            beliefs[FingerprintMatrixRuntime.combo_key(m, e)] = [
                FingerprintBelief.create(c.states, c.robot_lim, num_samples=ident["grid"],
                                         meas_capacity=ident["ring"], thresh=thresh, clip=clip,
                                         device=device) for _ in range(ident["objects"])]
        self.rt = FingerprintMatrixRuntime(
            c, model, fps, combos=combos, seek_combo=ident["seek_combo"],
            seek_fingerprint=ident["seek_fingerprint"], seek_mode=ident["seek_mode"],
            update_tdist_step=ident["adopt_step"], target_sharpness=ident["sharpness"],
            scene=scene, beliefs=beliefs, device=device)
        self.rows = fps.x.shape[0] * fps.x.shape[1]  # the match's forward rows
        self.graph = self.rt._ev.tick_graph
        self.state = self.rt.init(seed)
        while self.state.ev.step < ident["adopt_step"]:
            self.tick()

    def tick(self) -> dict:
        self.state, out = self.rt.tick(self.state, update_every=self.ident["update_every"])
        # the chunk's read takes one number a key: the distances' sum is
        # finite where every distance is
        return dict(out, dists=out["dists"].sum(), dist_table=out["dists"])

    def fill(self) -> int:
        return int(self.state.ev.pstate.memory.size)

    def snapshot(self) -> dict:
        st = self.state
        return dict(**planner_snapshot(st.ev.pstate), **env_snapshot(st.ev.env),
                    step=st.ev.step, **{f: _stacked(st.beliefs, f) for f in BELIEF_STATE})

    def outputs(self, snap: dict, info: dict) -> dict:
        st = self.state
        return dict(cost=info["cost"], robot_state=info["robot_state"], image=info["image"],
                    u=st.ev.pstate.u.clone(), trained=False, dists=info["dist_table"],
                    seek_k=int(info["seek_k"]), prior=_stacked(st.beliefs, "prior"),
                    prior_var=_stacked(st.beliefs, "prior_var"))

    def free(self) -> None:
        self.rt = self.state = self.graph = None

    def target(self, tick: Tick):
        return ref_identify.target(tick, self.seed, self.fps, self.ident)

    def recompute(self, tick: Tick, target, snap: dict, ring_y, u=None) -> dict:
        return ref_identify.identify_tick(tick, target, snap, u)

    def extra_gaps(self, prog: dict, ref: dict, snap: dict) -> dict:
        """``belief``: the worst relative gap of a belief's prior over its
        grid; ``belief_var``: the same of the variances; ``dists``: the
        worst relative gap of a combination's distances; ``seek``: 1 where
        the sought object differs."""
        worst = lambda name: max(_rel(p, r) for p, r in zip(prog[name].flatten(0, 1),
                                                              ref[name].flatten(0, 1)))
        return dict(belief=worst("prior"), belief_var=worst("prior_var"),
                    dists=max(_rel(p, r) for p, r in zip(prog["dists"], ref["dists"])),
                    seek=float(int(prog["seek_k"]) != int(ref["seek_k"])))

    def tick_flops(self, trained: bool) -> int:
        """The eval tick's and the match's forward of K*S rows."""
        f = counts.cvae_flops(self.cfg_dict)
        return (counts.tick_flops(self.cfg_dict, False, False)
                + self.rows * (f["encode"] + f["decode_mlp"] + f["img_decode"]))

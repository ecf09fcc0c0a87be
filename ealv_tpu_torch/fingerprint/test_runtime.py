"""The identification experiment (port of
``ealv_tpu/fingerprint/test_runtime.py``): an explorer collects (pose,
image) observations; every observation is matched against the stored
fingerprints and fused into one belief per (distance method, error mode)
combination and fingerprint; from ``update_tdist_step`` on, the explorer
plans toward an adopted belief (seek the object).

The reference runs the whole identification as one scanned device
program; here the same body runs as an eager loop. The adoption switch is
a host branch on the eval state's host step count. In the "uncertain" seek
mode the adopted belief is the one of largest entropy, picked by a device
``argmax`` with no host copy. The combinations of one observation share
its forward: their distances come from the same K*S-row match. The history
comes to the host in one copy at the end of ``run``.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.config import ExperimentConfig
from ..runtime.tester import EvalExperiment
from ..ops import renormalize
from .belief import FingerprintBelief
from .identify import FingerprintSet, best_matches, calibrate_thresholds, fuse_matches, \
    match_forward


def _make_target_pdf(sharpness: float):
    """The planner's target from an adopted belief, ``renormalize(pdf) **
    sharpness``: a fused belief lives in about [0, 1] with at most 2:1
    contrast and is unnormalized, which leaves the planner target-blind;
    renormalized and sharpened it has max 1 and real contrast. A constant
    belief stays uniform under any sharpness."""

    def pdf_fn(ctx, samples):
        return renormalize(ctx.pdf(samples)) ** sharpness

    return pdf_fn


def _belief_entropies(beliefs_k):
    """Entropy of each object's belief grid (K,), over the excess mass
    above the grid's minimum plus a small uniform floor: a flat belief
    scores the most, log(G), whatever its offset."""
    ents = []
    for b in beliefs_k:
        p = b.pdf_grid()
        p = p - p.min()
        p = p + 1e-3 * p.max() + 1e-9
        p = p / p.sum()
        ents.append(-(p * torch.log(p)).sum())
    return torch.stack(ents)


def _select(beliefs_k, k):
    """The belief of object ``k``, a () device index: every tensor of the
    K beliefs stacked and indexed on the device."""
    b0 = beliefs_k[0]
    pick = lambda name: torch.stack([getattr(b, name) for b in beliefs_k]).index_select(
        0, k.reshape(1))[0]
    return dataclasses.replace(b0, **{f.name: pick(f.name) for f in dataclasses.fields(b0)
                                      if torch.is_tensor(getattr(b0, f.name))})


def _identification_tick(ev_exp: EvalExperiment, model, fps: FingerprintSet, cfg, combos,
                         beliefs, seek_combo: int, seek_fp: int, update_tdist_step: int,
                         update_every: int, ev, robot_lim, tray_lim, seek_mode: str = "fixed",
                         draw=None):
    """One identification tick: the explore tick toward the adopted (or,
    before ``update_tdist_step``, a neutral) belief, then the match,
    relative-pose composition and fusion of every combination.
    ``seek_mode`` "fixed" adopts fingerprint ``seek_fp``'s belief,
    "uncertain" the least-localized object's (largest belief entropy).
    ``beliefs`` is one list of K beliefs per combination (updated in
    place), ``robot_lim``/``tray_lim`` the config's limits on the device,
    ``draw`` the tick's ``TickDraws``. Returns (ev, robot_state (d,), dists
    (C, K), seek_k ())."""
    dev = fps.x.device
    step = ev.step
    if seek_mode == "uncertain":
        k_star = torch.argmax(_belief_entropies(beliefs[seek_combo]))
        seek_b = _select(beliefs[seek_combo], k_star)
    else:
        k_star = torch.full((), seek_fp, dtype=torch.int64, device=dev)
        seek_b = beliefs[seek_combo][seek_fp]
    if step < update_tdist_step:  # not adopted yet: a neutral belief
        seek_b = dataclasses.replace(seek_b, prior=torch.full_like(seek_b.prior, 0.5),
                                     prior_var=torch.full_like(seek_b.prior_var, 2.0))
    ev, obs = ev_exp.tick(ev, seek_b, draw)
    if step % update_every == 0:
        out, seed_y = match_forward(model, fps, obs["image"])
        dists = []
        for ci, (method, err) in enumerate(combos):
            d, best = best_matches(out, seed_y, fps, method, err)
            beliefs[ci] = fuse_matches(beliefs[ci], d, best, obs["robot_state"], fps,
                                       cfg.states, robot_lim, tray_lim, err)
            dists.append(d)
        dists = torch.stack(dists)
    else:  # skipped: the beliefs stay, the distances are NaN
        dists = torch.full((len(combos), fps.center.shape[0]), float("nan"), device=dev)
    return ev, obs["robot_state"], dists, k_star


def _identification_loop(ev_exp: EvalExperiment, model, fps: FingerprintSet, cfg, combos,
                         beliefs, seek_combo: int, seek_fp: int, update_tdist_step: int,
                         update_every: int, n_steps: int, ev, seek_mode: str = "fixed",
                         draws=None):
    """``n_steps`` identification ticks (``_identification_tick``) from
    ``ev``; ``draws`` is one ``TickDraws`` a tick. Returns (ev, beliefs,
    outputs stacked on the device: robot_state (n, d), dists (n, C, K),
    seek_k (n,))."""
    beliefs = [list(bs) for bs in beliefs]
    dev = fps.x.device
    robot_lim, tray_lim = (torch.as_tensor(cfg.robot_lim, device=dev),
                           torch.as_tensor(cfg.tray_lim, device=dev))
    rows = {"robot_state": [], "dists": [], "seek_k": []}
    for i in range(n_steps):
        ev, *row = _identification_tick(
            ev_exp, model, fps, cfg, combos, beliefs, seek_combo, seek_fp,
            update_tdist_step, update_every, ev, robot_lim, tray_lim, seek_mode,
            draws[i] if draws else None)
        for key, v in zip(rows, row):
            rows[key].append(v)
    return ev, beliefs, {key: torch.stack(v) for key, v in rows.items()}


def _fetch(outs):
    """(robot_state, dists, seek_k) of the loop's outputs in one host copy."""
    rs, da, sk = outs["robot_state"], outs["dists"], outs["seek_k"]
    flat = torch.cat([rs.reshape(-1), da.reshape(-1), sk.float()]).cpu().numpy()
    a, b = rs.numel(), rs.numel() + da.numel()
    return (flat[:a].reshape(rs.shape), flat[a:b].reshape(da.shape),
            flat[b:].astype(np.int64))


def _peaks(beliefs):
    """Grid location of each belief's maximum."""
    return torch.stack([b.grid.index_select(0, b.pdf_grid().argmax().reshape(1))[0]
                        for b in beliefs]).cpu().numpy()


@dataclass
class FingerprintTestRuntime:
    """One (dist_method, error_mode) identification run."""

    cfg: ExperimentConfig
    model: object
    fps: FingerprintSet
    dist_method: str = "L2"
    error_mode: bool = False
    update_tdist_step: int = 50  # adopt a belief as the target from this step
    seek_fingerprint: int = 0  # whose belief is adopted
    target_sharpness: float = 20.0  # see _make_target_pdf; 1 = the raw belief
    scene: object = None
    beliefs: list = field(default_factory=list)
    history: list = field(default_factory=list)
    device: str = "cuda"

    def __post_init__(self):
        if not self.beliefs:
            thresh, clip = calibrate_thresholds(self.fps, self.dist_method)
            self.beliefs = [FingerprintBelief.create(self.cfg.states, self.cfg.robot_lim,
                                                     thresh=thresh, clip=clip,
                                                     device=self.device)
                            for _ in range(self.fps.center.shape[0])]
        self._ev = EvalExperiment(self.cfg, _make_target_pdf(self.target_sharpness),
                                  scene=self.scene, device=self.device)

    def run(self, n_steps: int, seed: int = 0, update_every: int = 1, draws=None):
        """Explore for ``n_steps``, updating every fingerprint's belief from
        every ``update_every``-th observation. Returns (beliefs, history)."""
        ev, beliefs, outs = _identification_loop(
            self._ev, self.model, self.fps, self.cfg, ((self.dist_method, self.error_mode),),
            [self.beliefs], 0, self.seek_fingerprint, self.update_tdist_step, update_every,
            n_steps, self._ev.init(seed=seed), draws=draws)
        rs, da, sk = _fetch(outs)
        for i in range(0, n_steps, update_every):
            self.history.append({"step": i, "dists": da[i, 0], "robot_state": rs[i],
                                 "seek_k": int(sk[i])})
        self.beliefs = beliefs[0]
        return self.beliefs, self.history

    def belief_peaks(self):
        """Grid location of each fingerprint's belief maximum."""
        return _peaks(self.beliefs)

    def save(self, path: str, names=None) -> str:
        """Save the belief grids (``io.save_beliefs``)."""
        from .io import save_beliefs
        return save_beliefs(path, self.beliefs, names)


@dataclass
class FingerprintMatrixRuntime:
    """Every (dist_method, error_mode) combination evaluated from one
    exploration: one belief list per combination, all updated from the same
    observations; ``seek_combo``'s beliefs steer the explorer."""

    cfg: ExperimentConfig
    model: object
    fps: FingerprintSet
    # the latent-distance methods and one reconstruction-error combination
    combos: tuple = (("L2", False), ("KL", False), ("BC", False), ("L2", True))
    seek_combo: int = 0
    seek_fingerprint: int = 0
    seek_mode: str = "fixed"  # or "uncertain": the largest-entropy object's belief
    update_tdist_step: int = 50
    target_sharpness: float = 20.0
    scene: object = None
    beliefs: dict = field(default_factory=dict)  # combo key -> [K beliefs]
    history: list = field(default_factory=list)
    device: str = "cuda"

    @staticmethod
    def combo_key(method: str, error_mode: bool) -> str:
        return f"{method}_error" if error_mode else method

    def __post_init__(self):
        k = self.fps.center.shape[0]
        for method, err in self.combos:
            key = self.combo_key(method, err)
            if key not in self.beliefs:
                thresh, clip = calibrate_thresholds(self.fps, method)
                self.beliefs[key] = [FingerprintBelief.create(
                    self.cfg.states, self.cfg.robot_lim, thresh=thresh, clip=clip,
                    device=self.device) for _ in range(k)]
        self._ev = EvalExperiment(self.cfg, _make_target_pdf(self.target_sharpness),
                                  scene=self.scene, device=self.device)

    def run(self, n_steps: int, seed: int = 0, update_every: int = 1, draws=None):
        """One exploration; every combination's beliefs are updated from
        every ``update_every``-th observation. Returns (beliefs dict,
        history)."""
        keys = [self.combo_key(m, e) for m, e in self.combos]
        ev, beliefs, outs = _identification_loop(
            self._ev, self.model, self.fps, self.cfg, self.combos,
            [self.beliefs[key] for key in keys], self.seek_combo, self.seek_fingerprint,
            self.update_tdist_step, update_every, n_steps, self._ev.init(seed=seed),
            seek_mode=self.seek_mode, draws=draws)
        rs, da, sk = _fetch(outs)
        for i in range(0, n_steps, update_every):
            rec = {"step": i, "robot_state": rs[i], "seek_k": int(sk[i])}
            rec.update({key: da[i, ci] for ci, key in enumerate(keys)})
            self.history.append(rec)
        self.seek_history = sk
        self.beliefs.update(zip(keys, beliefs))
        return self.beliefs, self.history

    def belief_peaks(self, key: str):
        return _peaks(self.beliefs[key])

    def results_table(self, truth=None, plot_idx=(0, 1)):
        """Per combination: the belief peaks and, with ``truth`` rows, each
        object's localization error over ``plot_idx`` and their mean."""
        plot_idx = list(plot_idx)
        table = {}
        for method, err in self.combos:
            key = self.combo_key(method, err)
            row = {"peaks": self.belief_peaks(key)}
            if truth is not None:
                t = np.asarray(truth)[:, plot_idx]
                row["error"] = np.linalg.norm(row["peaks"][:, plot_idx] - t, axis=1)
                row["mean_error"] = float(row["error"].mean())
            table[key] = row
        return table

    def save(self, dir_path: str, names=None):
        """One belief file per combination, beliefs_{key}.npz."""
        from .io import save_beliefs
        return {key: save_beliefs(os.path.join(dir_path, f"beliefs_{key}.npz"),
                                  self.beliefs[key], names)
                for key in (self.combo_key(m, e) for m, e in self.combos)}

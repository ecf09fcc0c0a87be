"""The identification experiment (port of
``ealv_tpu/fingerprint/test_runtime.py``): an explorer collects (pose,
image) observations; every observation is matched against the stored
fingerprints and fused into one belief per (distance method, error mode)
combination and fingerprint; from ``update_tdist_step`` on, the explorer
plans toward an adopted belief (seek the object).

The reference runs the whole identification as one scanned device
program; here each identification tick is one step of the runtime's
``EvalExperiment`` (``EvalExperiment.step``): on the card one captured
CUDA graph a pattern, whose carry is the eval state and every
combination's beliefs. The adoption switch (``step <
update_tdist_step``) and the update skip (``step % update_every``) are
host branches on the eval state's host step count, so they key the
patterns beside the arm's drift correction: a run has two to four. In the
"uncertain" seek mode the adopted belief is the one of largest entropy,
picked by a device ``argmax`` with no host copy. The combinations of one
observation share its forward: their distances come from the same K*S-row
match. ``init`` and ``tick`` make a run one tick at a time, and ``run``
is a loop over ``tick``; the history comes to the host in one copy at the
end of ``run``, and the beliefs ``run`` returns are copies, not the
graph's static buffers.

Each tick is a tick of the tracer (``runtime/tracing.py``): its device
span ``tick`` covers the whole step, with ``seek`` (the entropies and the
selection), the eval tick's own spans, ``match`` (the K*S-row forward and
every combination's best matches) and ``fuse`` (the relative poses, the
pushes and every belief's fusion) inside.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.config import ExperimentConfig
from ..runtime import tracing
from ..runtime.graphs import _addresses, _clone, module_key
from ..runtime.tester import EvalExperiment, EvalState
from ..ops import renormalize
from .belief import FingerprintBelief, push_and_fuse
from .identify import FingerprintSet, best_matches, calibrate_thresholds, match_forward, \
    match_pushes


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
    """One identification tick, one step of ``ev_exp`` (through its tick
    graph where it has one): the explore tick toward the adopted (or,
    before ``update_tdist_step``, a neutral) belief, then the match,
    relative-pose composition and fusion of every combination.
    ``seek_mode`` "fixed" adopts fingerprint ``seek_fp``'s belief,
    "uncertain" the least-localized object's (largest belief entropy).
    ``beliefs`` is one list of K beliefs per combination (updated in
    place), ``robot_lim``/``tray_lim`` the config's limits on the device,
    ``draw`` the tick's ``TickDraws``. Returns (ev, robot_state (d,), dists
    (C, K), seek_k (), cost (), image (H, W, C)): the explore tick's plan
    cost and camera image beside the identification's outputs."""
    adopted, update = ev.step >= update_tdist_step, ev.step % update_every == 0

    def run(view, bel, d):
        bel = [list(bs) for bs in bel]
        view, *out = _identification_body(ev_exp, model, fps, cfg, combos, bel, seek_combo,
                                          seek_fp, adopted, update, view, robot_lim,
                                          tray_lim, seek_mode, d)
        return view, bel, tuple(out)

    pattern = ("identify", tuple(combos), seek_combo, seek_fp, seek_mode, adopted, update)
    with tracing.tick():
        ev, new, out = ev_exp.step(ev, beliefs, draw, run, pattern, module_key(model),
                                   _addresses(fps), _addresses((robot_lim, tray_lim)))
    beliefs[:] = [list(bs) for bs in new]
    return (ev, *out)


def _identification_body(ev_exp: EvalExperiment, model, fps: FingerprintSet, cfg, combos,
                         beliefs, seek_combo: int, seek_fp: int, adopted: bool, update: bool,
                         ev, robot_lim, tray_lim, seek_mode: str, draw):
    """The identification tick's body (``_identification_tick``), its two
    host branches given: ``adopted`` (else the target is a neutral belief)
    and ``update`` (else the beliefs stay and the distances are NaN). Every
    combination is matched before any is fused: a match reads no belief."""
    dev = fps.x.device
    tracing.begin("seek")
    if seek_mode == "uncertain":
        k_star = torch.argmax(_belief_entropies(beliefs[seek_combo]))
        seek_b = _select(beliefs[seek_combo], k_star)
    else:
        k_star = torch.full((), seek_fp, dtype=torch.int64, device=dev)
        seek_b = beliefs[seek_combo][seek_fp]
    if not adopted:
        seek_b = dataclasses.replace(seek_b, prior=torch.full_like(seek_b.prior, 0.5),
                                     prior_var=torch.full_like(seek_b.prior_var, 2.0))
    tracing.end("seek")
    ev, obs = ev_exp._tick(ev, seek_b, draw)
    if update:
        tracing.begin("match")
        out, seed_y = match_forward(model, fps, obs["image"])
        matches = [best_matches(out, seed_y, fps, method, err) for method, err in combos]
        tracing.end("match")
        tracing.begin("fuse")
        # every combination's relative poses, then all C*K fusions in one call
        pushes = [p for (d, best), (_, err) in zip(matches, combos)
                  for p in match_pushes(d, best, obs["robot_state"], fps, cfg.states,
                                        robot_lim, tray_lim, err)]
        fused = push_and_fuse([b for bs in beliefs for b in bs], pushes)
        k = fps.center.shape[0]
        beliefs[:] = [fused[ci * k:(ci + 1) * k] for ci in range(len(combos))]
        tracing.end("fuse")
        dists = torch.stack([d for d, _ in matches])
    else:
        dists = torch.full((len(combos), fps.center.shape[0]), float("nan"), device=dev)
    return ev, obs["robot_state"], dists, k_star, obs["cost"], obs["image"]


@dataclass
class IdentificationState:
    """An identification run between two ticks: the eval state and one list
    of K beliefs a combination. After a replay both are the tick graph's
    static buffers, which the next replay overwrites."""

    ev: EvalState
    beliefs: list


class _Identification:
    """What the two runtimes share: ``init``, ``tick`` and the loop of
    ``run``. A runtime gives ``_combos``, ``_seek`` (combination and mode)
    and ``_belief_lists`` (its beliefs in the combinations' order)."""

    def _setup(self):
        self._ev = EvalExperiment(self.cfg, _make_target_pdf(self.target_sharpness),
                                  scene=self.scene, device=self.device)
        dev = self.fps.x.device
        # on the device once: the tick graphs read them in place
        self._lims = (torch.as_tensor(self.cfg.robot_lim, device=dev),
                      torch.as_tensor(self.cfg.tray_lim, device=dev))

    def init(self, seed: int = 0) -> IdentificationState:
        """A run's start: the explorer at the tray centre, its draws seeded
        with ``seed``, the beliefs as the runtime holds them."""
        return IdentificationState(ev=self._ev.init(seed=seed),
                                   beliefs=[list(bs) for bs in self._belief_lists()])

    def tick(self, state: IdentificationState, draw=None, update_every: int = 1):
        """One identification tick (``_identification_tick``) from ``state``;
        ``draw`` feeds the planner. Returns (state, {robot_state (d,), dists
        (C, K), seek_k (), cost (), image (H, W, C)}), the outputs cloned."""
        beliefs = [list(bs) for bs in state.beliefs]
        seek_combo, seek_mode = self._seek()
        ev, *out = _identification_tick(
            self._ev, self.model, self.fps, self.cfg, self._combos(), beliefs, seek_combo,
            self.seek_fingerprint, self.update_tdist_step, update_every, state.ev, *self._lims,
            seek_mode, draw)
        keys = ("robot_state", "dists", "seek_k", "cost", "image")
        return IdentificationState(ev=ev, beliefs=beliefs), dict(zip(keys, out))

    def _loop(self, n_steps: int, seed: int, update_every: int, draws):
        """``n_steps`` ticks from ``init(seed)``; ``draws`` is one
        ``TickDraws`` a tick. Returns (the last state, robot_state (n, d),
        dists (n, C, K), seek_k (n,) in one host copy)."""
        state = self.init(seed)
        rows = {"robot_state": [], "dists": [], "seek_k": []}
        for i in range(n_steps):
            state, out = self.tick(state, draws[i] if draws else None, update_every)
            for key in rows:
                rows[key].append(out[key])
        return (state, *_fetch({key: torch.stack(v) for key, v in rows.items()}))


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
class FingerprintTestRuntime(_Identification):
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
        self._setup()

    def _combos(self):
        return ((self.dist_method, self.error_mode),)

    def _seek(self):
        return 0, "fixed"

    def _belief_lists(self):
        return [self.beliefs]

    def run(self, n_steps: int, seed: int = 0, update_every: int = 1, draws=None):
        """Explore for ``n_steps``, updating every fingerprint's belief from
        every ``update_every``-th observation. Returns (beliefs, history)."""
        state, rs, da, sk = self._loop(n_steps, seed, update_every, draws)
        for i in range(0, n_steps, update_every):
            self.history.append({"step": i, "dists": da[i, 0], "robot_state": rs[i],
                                 "seek_k": int(sk[i])})
        self.beliefs = _clone(state.beliefs[0])
        return self.beliefs, self.history

    def belief_peaks(self):
        """Grid location of each fingerprint's belief maximum."""
        return _peaks(self.beliefs)

    def save(self, path: str, names=None) -> str:
        """Save the belief grids (``io.save_beliefs``)."""
        from .io import save_beliefs
        return save_beliefs(path, self.beliefs, names)


@dataclass
class FingerprintMatrixRuntime(_Identification):
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
        self._setup()

    def _combos(self):
        return self.combos

    def _seek(self):
        return self.seek_combo, self.seek_mode

    def _belief_lists(self):
        return [self.beliefs[self.combo_key(m, e)] for m, e in self.combos]

    def run(self, n_steps: int, seed: int = 0, update_every: int = 1, draws=None):
        """One exploration; every combination's beliefs are updated from
        every ``update_every``-th observation. Returns (beliefs dict,
        history)."""
        keys = [self.combo_key(m, e) for m, e in self.combos]
        state, rs, da, sk = self._loop(n_steps, seed, update_every, draws)
        for i in range(0, n_steps, update_every):
            rec = {"step": i, "robot_state": rs[i], "seek_k": int(sk[i])}
            rec.update({key: da[i, ci] for ci, key in enumerate(keys)})
            self.history.append(rec)
        self.seek_history = sk
        self.beliefs.update(zip(keys, _clone(state.beliefs)))
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

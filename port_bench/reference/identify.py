"""One identification tick recomputed in plain torch from the program's
state before the tick: a frozen copy of the port's identification step
(``ealv_tpu_torch/fingerprint/test_runtime.py`` with ``identify.py``,
``distances.py`` and ``belief.py``).

The tick: pick the belief to seek (the largest-entropy object's of the
seek combination, or a fixed one; before adoption a neutral belief in its
place); one exploration tick (``tick.Tick.explore``) toward that belief,
renormalized and raised to the sharpness; one eval-mode forward of the
CVAE over the K*S stored seed poses with the tick's image; each
combination's distances (latent L2, KL or Bhattacharyya, or the
reconstruction error) and best seed a fingerprint; the relative pose of
each best match (with its yaw reflection) or, in error mode, the test
pose, pushed with the distance into the belief's ring; and each belief's
fusion (``belief.Belief.update_prior``), in float32.

What the tick reads of the program: the planner's and the env's state, the
beliefs' state (``snap``), and the fingerprints the program captured at
set-up (their latents, poses, centres and mask). The CVAE comes from the
seed and the scene from the seed and the object count; the thresholds
are calibrated here from the fingerprints. The ``Tick``'s controls hold:
its ``cast`` rounds the CVAE's products, ``half_batch`` matches against
the first half of each fingerprint's seeds only, ``stuck`` returns the
state before the tick and the beliefs unchanged.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .belief import Belief, grid_for
from .kernels import renormalize
from .renderer import TrayScene
from .tick import Tick, ws_conversion

BELIEF_STATE = ("prior", "prior_var", "meas_loc", "meas_val", "meas_n", "count")


def make_scene(k: int, seed: int, device) -> TrayScene:
    """K objects on a jittered ring inside the tray, drawn with numpy from
    ``seed``: the port's ``TrayScene.make``."""
    rng = np.random.default_rng(seed)
    cx, cy, r0 = 0.475, 0.0, 0.065
    ang = 2 * np.pi * (np.arange(k) / k) + rng.uniform(-0.2, 0.2, k)
    xy = np.stack([cx + r0 * np.cos(ang), cy + r0 * np.sin(ang)], 1)
    hues = np.linspace(0.0, 1.0, k, endpoint=False)
    colors = np.stack([0.5 + 0.45 * np.cos(2 * np.pi * (hues + s))
                       for s in (0.0, 1 / 3, 2 / 3)], 1)
    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    return TrayScene(obj_xy=t(xy), obj_radius=t(0.026 + 0.012 * rng.random(k)),
                     obj_height=t(0.21 + 0.05 * rng.random(k)), obj_color=t(colors),
                     ground_color=t([0.45, 0.35, 0.3]))


def latent_distance(method: str, z1_mu, z1_logvar, z2_mu, z2_logvar):
    """L2 of the means (reduced over every axis but the first), KL(N1 ||
    N2) or the Bhattacharyya distance of diagonal Gaussians (over the last
    axis)."""
    diff = z1_mu - z2_mu
    if method == "L2":
        return torch.sqrt((diff ** 2).sum(tuple(range(1, diff.ndim))))
    z1_var, z2_var = torch.exp(z1_logvar), torch.exp(z2_logvar)
    if method == "KL":
        mu_diff = ((z1_var + diff ** 2) / (2 * z2_var)).sum(-1)
        var_diff = (z2_logvar / 2 - z1_logvar / 2).sum(-1)
        return var_diff + mu_diff - 0.5 * diff.shape[-1]
    if method == "BC":
        mu_diff = (diff ** 2 / (z1_var + z2_var)).sum(-1)
        var_prod = (torch.log((z1_var + z2_var) / 2) - z1_logvar / 2 - z2_logvar / 2).sum(-1)
        return 0.25 * mu_diff + 0.5 * var_prod
    raise ValueError(f"no distance {method!r}")


def calibrate(fps: dict, method: str) -> tuple:
    """(thresh, clip) from the fingerprints' separation: the least distance
    between seeds of two fingerprints, and twice the largest (one
    fingerprint: the mean and twice the largest positive distance between
    its own seeds)."""
    k, s, z = fps["z_mu"].shape
    a = k * s
    mu, lv = fps["z_mu"].reshape(a, z), fps["z_logvar"].reshape(a, z)
    d = latent_distance(method, mu.repeat_interleave(a, 0), lv.repeat_interleave(a, 0),
                        mu.repeat(a, 1), lv.repeat(a, 1)).reshape(a, a)
    valid = fps["mask"].reshape(a) > 0
    pair = valid[:, None] & valid[None, :]
    if k > 1:
        fp = torch.arange(k, device=d.device).repeat_interleave(s)
        cross = d[(fp[:, None] != fp[None, :]) & pair]
        return float(cross.min()), float(cross.max()) * 2.0
    within = d[pair & (d > 0)]
    return float(within.sum() / max(within.numel(), 1)), float(within.max()) * 2.0


def _rz(a):
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def relative_poses(states: str, test, fp_x, centers, robot_lim, tray_lim):
    """Where each fingerprint's object lies if the test pose sees it as the
    best seed pose ``fp_x`` (K, d) saw it: with yaw, the centre offset
    rotated by R_fp^T R_test and added to the test position, the yaw
    composed as R_fp^T R_centre R_test and wrapped to [-pi, pi), then the
    K rows again with the yaw reflected (w + 2 pi sign w); without yaw,
    test - fp + centre. Returns (2K or K, d) in the state order."""
    if "w" not in states:
        return test[None, :] - fp_x + centers
    wi = states.rfind("w")
    rl, tl = robot_lim[wi:wi + 1], tray_lim[wi:wi + 1]
    to_tray = lambda v: ws_conversion(v[..., None], rl, tl)[..., 0]
    to_robot = lambda v: ws_conversion(v[..., None], tl, rl)[..., 0]

    def xyz(v):
        return torch.stack([v[..., states.rfind(c)] if c in states else v.new_zeros(v.shape[:-1])
                            for c in "xyz"], -1)

    fp_w = to_tray(fp_x[:, wi])
    fp_rot_t = _rz(fp_w).transpose(-1, -2)
    test_rot = _rz(to_tray(test[wi]).expand(fp_w.shape))
    centre_rot = _rz(to_tray(centers[:, wi]))
    offset = xyz(centers) - xyz(fp_x)
    pos = xyz(test).expand(offset.shape) + torch.einsum("kij,kjl,kl->ki", fp_rot_t, test_rot,
                                                        offset)
    comp = fp_rot_t @ centre_rot @ test_rot
    w = torch.atan2(comp[:, 1, 0], comp[:, 0, 0])
    w = (w + math.pi) % (2 * math.pi) - math.pi
    pos = torch.cat([pos, pos], 0)
    w = to_robot(torch.cat([w, w + 2 * math.pi * torch.sign(w)], 0))
    cols = [w if c == "w" else pos[:, "xyz".index(c)] if c in "xyz"
            else test[states.rfind(c)].expand(w.shape) for c in states]
    return torch.stack(cols, -1)


class Sharpened:
    """The planner's target from a belief: ``renormalize(pdf) **
    sharpness`` (a reference planner's ``pdf_fn`` calls ``ctx[0].pdf(ctx[1],
    samples)``)."""

    def __init__(self, sharpness: float):
        self.sharpness = sharpness

    def pdf(self, belief: Belief, samples):
        return renormalize(belief.pdf(samples)) ** self.sharpness


def target(tick: Tick, seed: int, fps: dict, ident: dict) -> dict:
    """What every tick of a run shares: the CVAE at the seed's weights in
    the tick's precision, the scene (set on ``tick``), the fingerprints
    (with ``half_batch``, the second half of each one's seeds masked), each
    combination's thresholds and the grid."""
    dev = tick.device
    tick.scene = make_scene(ident["objects"], seed, dev)
    fps = {k: v.to(dev) for k, v in fps.items()}
    if tick.half_batch:
        mask = fps["mask"].clone()
        mask[:, (mask.shape[1] + 1) // 2:] = 0.0
        fps["mask"] = mask
    grid, lims, scale = grid_for(tick.cfg.states, tick.cfg.robot_lim, ident["grid"], dev)
    return dict(model=tick.make_model(seed), fps=fps, ident=ident,
                combos=[(m, bool(e)) for m, e in ident["combos"]],
                thresholds=[calibrate(fps, m) for m, _ in ident["combos"]],
                grid=grid, lims=lims, scale=scale)


def beliefs_of(snap: dict, tgt: dict) -> list:
    """The beliefs before the tick, one list of K a combination, from the
    snapshot's stacked (C, K, ...) state."""
    out = []
    for c, (thresh, clip) in enumerate(tgt["thresholds"]):
        out.append([Belief(grid=tgt["grid"], lims=tgt["lims"],
                           **{f: snap[f][c, k] for f in BELIEF_STATE},
                           num_samples=tgt["ident"]["grid"], scale=tgt["scale"],
                           thresh=thresh, clip=clip)
                    for k in range(snap["prior"].shape[1])])
    return out


def best_matches(out, seed_y, fps: dict, method: str, error_mode: bool):
    """(best distance (K,), best seed pose (K, d)): the distance of the
    test image's forward at each seed pose to the seed's stored latent (or
    the reconstruction error), masked seeds at inf, the least a
    fingerprint."""
    k, s, d = fps["x"].shape
    if error_mode:
        dist = torch.sqrt(((out["img_pred"] - seed_y) ** 2).sum((1, 2, 3))).reshape(k, s)
    else:
        z = fps["z_mu"].shape[-1]
        dist = latent_distance(method, fps["z_mu"].reshape(k * s, z),
                               fps["z_logvar"].reshape(k * s, z), out["z_mu"],
                               out["z_logvar"]).reshape(k, s)
    dist = torch.where(fps["mask"] > 0, dist, torch.full_like(dist, float("inf")))
    best = dist.argmin(1)
    rows = torch.arange(k, device=dist.device)
    return dist[rows, best], fps["x"][rows, best]


def fuse(beliefs: list, dist, best_x, test, fps: dict, states: str, robot_lim, tray_lim,
         error_mode: bool) -> list:
    """Each fingerprint's measurement(s) pushed with its distance, and the
    belief fused."""
    if error_mode:
        return [b.push(test, dist[i]).update_prior() for i, b in enumerate(beliefs)]
    poses = relative_poses(states, test, best_x, fps["center"], robot_lim, tray_lim)
    k = len(beliefs)
    new = []
    for i, b in enumerate(beliefs):
        for r in range(poses.shape[0] // k):
            b = b.push(poses[r * k + i], dist[i])
        new.append(b.update_prior())
    return new


def identify_tick(tick: Tick, tgt: dict, snap: dict, u=None) -> dict:
    """One identification tick from ``snap`` (``u`` as in
    ``Tick.explore``). Returns the explore tick's cost, robot state, image
    and plan, and the identification's ``prior`` and ``prior_var`` (C, K,
    G) after it, ``dists`` (C, K) and ``seek_k``."""
    ident, cfg, dev = tgt["ident"], tick.cfg, tick.device
    beliefs = beliefs_of(snap, tgt)
    seek = beliefs[ident["seek_combo"]]
    if ident["seek_mode"] == "uncertain":
        k_star = int(torch.argmax(torch.stack([b.entropy() for b in seek])))
    else:
        k_star = ident["seek_fingerprint"]
    seek_b = seek[k_star]
    if snap["step"] < ident["adopt_step"]:
        seek_b = dataclasses.replace(seek_b, prior=torch.full_like(seek_b.prior, 0.5),
                                     prior_var=torch.full_like(seek_b.prior_var, 2.0))
    n_c, n_k = len(beliefs), len(beliefs[0])
    if tick.stuck:
        out = tick.stuck_tick(snap)
        dists = torch.zeros((n_c, n_k), device=dev)
    else:
        plan, info, _, robot_state, img, _ = tick.explore(
            snap, (Sharpened(ident["sharpness"]), seek_b), u)
        out = dict(cost=info["cost"], robot_state=robot_state, image=img, u=plan)
        if snap["step"] % ident["update_every"] == 0:
            fps = tgt["fps"]
            k, s, d = fps["x"].shape
            seed_y = img[None].expand(k * s, *img.shape)
            with torch.no_grad():
                fwd = tgt["model"](fps["x"].reshape(k * s, d), seed_y, train=False)
            lims = [torch.as_tensor(v, dtype=torch.float32, device=dev)
                    for v in (cfg.robot_lim, cfg.tray_lim)]
            dists = []
            for c, (method, err) in enumerate(tgt["combos"]):
                dist, best_x = best_matches(fwd, seed_y, fps, method, err)
                beliefs[c] = fuse(beliefs[c], dist, best_x, robot_state, fps, cfg.states,
                                  *lims, err)
                dists.append(dist)
            dists = torch.stack(dists)
        else:
            dists = torch.full((n_c, n_k), float("nan"), device=dev)
    stack = lambda f: torch.stack([torch.stack([getattr(b, f) for b in bs]) for bs in beliefs])
    out.update(prior=stack("prior"), prior_var=stack("prior_var"), dists=dists, seek_k=k_star)
    return out

"""Fingerprint capture (port of ``ealv_tpu/fingerprint/capture.py``): around
each cluster centre, a short ergodic exploration toward a sphere, cylinder
or cone ``ExplrDist`` target with sampling limits shrunk around the centre
and a kernel ten times narrower, recording the latent (z_mu, z_logvar) of
every observation at poses at least ``min_pose_dist`` apart.

The capture is an eager loop of ``EvalExperiment.tick`` and the latent
encode; the latents, poses and the first image stay on the device and come
to the host in one copy at the end. The reference renders its
``center_img`` from a tick that starts from the same state with the same
key as its first capture tick and throws that tick away; here the first
capture tick's image is ``center_img``, the same image, since a second
tick from the same state cannot be taken (the planner's memory ring and
its generator move on in place).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..control.target_dists import ExplrDist
from ..models import CVAE
from ..models.cvae import init_model_state, update_dist
from ..runtime.tester import EvalExperiment
from .clustering import ClusterResult, find_clusters


def make_capture_target(explr_states: str, robot_center, mode: str = "sphere",
                        capacity: int = 600, device="cuda") -> ExplrDist:
    """The capture's exploration target around ``robot_center``: 'sphere'
    is one tight component at the centre (xyz std 0.01, angles free),
    'cylinder' the same with z free, 'cone' 500 components sampling a cone
    below a tip above the centre (tip z = 0.5, R = 0.2, H = 1.5; drawn
    from ``default_rng(0)``)."""
    robot_center = np.asarray(robot_center, np.float32)
    d = len(explr_states)
    dist = ExplrDist.create(capacity, d, device=device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if mode == "cone":
        rng = np.random.default_rng(0)
        num, R_, H_ = 500, 0.2, 1.5
        tip = np.ones(3, np.float32)
        tip[0], tip[1], tip[2] = robot_center[0], robot_center[1], 0.5
        samps = rng.uniform([0, 0, 0], [2 * np.pi, H_, R_], size=(num, 3))
        phi, h = samps[:, 0], samps[:, 1]
        r = np.clip(samps[:, 2], 0, R_ * samps[:, 1] / H_)
        pts = tip[:, None] - np.array([r * np.cos(phi), r * np.sin(phi), h])
        means, stds = [], []
        for pt in pts.T.astype(np.float32):
            full = robot_center.copy()
            full[:3] = pt
            vals = np.ones(d, np.float32)
            vals[:3] *= -(pt[-1] - 1) * 0.025
            vals[3:] *= np.pi
            means.append(full)
            stds.append(vals)
        n = len(means)
        return ExplrDist(means=torch.cat([t(means), dist.means[n:]]),
                         stds=torch.cat([t(stds), dist.stds[n:]]),
                         size=torch.full_like(dist.size, n))
    vals = np.ones(d, np.float32)
    locs = robot_center.copy()
    for i, s in enumerate(explr_states):
        if s in "xyz" and not (mode == "cylinder" and s == "z"):
            vals[i] = 0.01
        else:  # angles, and z in a cylinder, are free
            vals[i] = 2.0
            locs[i] = 0.0
    return dist.push(t(locs), t(vals))


def capture_fingerprint(model: CVAE, cfg, center_robot, scene=None, num_steps: int = 50,
                        mode: str = "sphere", min_pose_dist: float = 1e-3, seed: int = 0,
                        explr_states: Optional[str] = None, draws=None, device="cuda"):
    """Mini ergodic exploration around one centre (robot coords over the
    explored states): drive there with the pose controller, then
    ``num_steps`` ticks, encoding each observation. ``draws`` is a list of
    one ``TickDraws`` a tick, fed to the planner. Returns the fingerprint
    {z_mu, z_var (the logvar), x, center, center_img} as numpy."""
    explr_states = explr_states or cfg.states
    target = make_capture_target(explr_states, center_robot, mode, device=device)
    ev_exp = EvalExperiment(cfg, lambda ctx, samples: ctx.pdf(samples),
                            explr_states=explr_states, scene=scene,
                            kernel_std_scale=0.1, device=device)

    # the tray pose over the centre; the other pose states at mid-range
    sub = [cfg.states.rfind(s) for s in explr_states]
    rl, tl = cfg.robot_lim[sub], cfg.tray_lim[sub]
    center = np.asarray(center_robot, np.float32)
    center_tray = ((center[: len(sub)] - rl[:, 0]) / (rl[:, 1] - rl[:, 0])
                   * (tl[:, 1] - tl[:, 0]) + tl[:, 0])
    tray_pose6 = np.array([(lo + hi) / 2 for lo, hi in ev_exp.env.tray_lim], np.float32)
    for i, s in enumerate(explr_states):
        raw_i = "xyzrpw".find(s)
        if raw_i >= 0:
            tray_pose6[raw_i] = center_tray[i]

    ev = ev_exp.init(start_tray_pose=tray_pose6, seed=seed, shrink_center=center)
    ev = ev_exp.use_pose(ev, tray_pose6)
    mstate = init_model_state(model, ev_exp.device)
    zm, zv, xs = [], [], []
    for i in range(num_steps):
        ev, obs = ev_exp.tick(ev, target, draws[i] if draws else None)
        if i == 0:
            img0 = obs["image"]
        _, out = update_dist(model, mstate, obs["robot_state"], obs["image"])
        zm.append(out["z_mu"][0])
        zv.append(out["z_logvar"][0])
        xs.append(obs["robot_state"])
    # one host copy of everything the capture kept
    parts = [torch.stack(zm), torch.stack(zv), torch.stack(xs), img0]
    flat = torch.cat([p.float().reshape(-1) for p in parts]).cpu().numpy()
    zm, zv, xs_all, center_img = np.split(flat, np.cumsum([p.numel() for p in parts])[:-1])
    zm, zv = zm.reshape(num_steps, -1), zv.reshape(num_steps, -1)
    xs_all = xs_all.reshape(num_steps, -1)

    # greedy filter: keep a pose only >= min_pose_dist from the last kept
    keep, last_pose = [], None
    for i in range(num_steps):
        if last_pose is None or np.linalg.norm(xs_all[i] - last_pose) >= min_pose_dist:
            keep.append(i)
            last_pose = xs_all[i]
    return {"z_mu": zm[keep], "z_var": zv[keep], "x": xs_all[keep],
            "center": center, "center_img": center_img.reshape(tuple(img0.shape))}


def build_fingerprints(model: CVAE, cfg, seeds_x, seeds_y, scene=None, num_steps: int = 50,
                       mode: str = "sphere", num_pts: int = 1000,
                       cluster_kwargs: Optional[dict] = None, out_dir: Optional[str] = None,
                       generator: torch.Generator | None = None, cluster_draws=None,
                       device="cuda"):
    """Cluster the model's uncertainty field, then capture a fingerprint at
    every centre found (seed k for centre k). Returns (fingerprint dicts,
    ClusterResult); with ``out_dir`` each is saved as
    {out_dir}/fp{k}_{mode}.npz."""
    res: ClusterResult = find_clusters(model, seeds_x, seeds_y, robot_lim=cfg.robot_lim,
                                       num_pts=num_pts, generator=generator,
                                       draws=cluster_draws, **(cluster_kwargs or {}))
    dicts = []
    for k, center_xy in enumerate(res.means):
        center = np.zeros(len(cfg.states), np.float32)
        center[:2] = center_xy[:2]
        fp = capture_fingerprint(model, cfg, center, scene=scene, num_steps=num_steps,
                                 mode=mode, seed=k, device=device)
        dicts.append(fp)
        if out_dir:
            from .io import save_fingerprint
            save_fingerprint(f"{out_dir}/fp{k}_{mode}", fp)
    return dicts, res

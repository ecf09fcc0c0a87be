"""Fingerprint identification (port of ``ealv_tpu/fingerprint/identify.py``):
match a live (pose, image) observation against the stored signatures of K
fingerprints, turn each best match into a relative-pose belief sample and
fuse it into that fingerprint's belief grid.

The K fingerprints x S seeds are one batched forward of K*S rows, the
counterpart of the reference's ``jax.vmap``; the best seed of each
fingerprint is a device ``argmin``, so no step of an identification waits
on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import CVAE
from ..utils.states import ws_conversion
from .distances import latent_distance


def _encode_seed_z(model: CVAE, seeds_x, seeds_y, seeds_force=None):
    """Latents of a batch of (x, y) pairs (eval-mode encode); with
    ``learn_force`` a missing force encodes as zero."""
    force = None
    if model.learn_force:
        force = seeds_force if seeds_force is not None else seeds_x.new_zeros(
            (seeds_x.shape[0], 1))
    with torch.no_grad():
        return model(seeds_x, seeds_y, force=force, train=False)["z"]


class FingerprintSet(NamedTuple):
    """K stacked fingerprints, S seeds each (padded, with a mask)."""

    z_mu: torch.Tensor  # (K, S, z)
    z_logvar: torch.Tensor  # (K, S, z)
    x: torch.Tensor  # (K, S, d) seed poses (robot coords)
    center: torch.Tensor  # (K, d)
    center_img: torch.Tensor  # (K, H, W, C)
    mask: torch.Tensor  # (K, S) valid seeds

    @classmethod
    def from_lists(cls, dicts, device="cuda"):
        """Stack capture dicts {z_mu, z_var, x, center, center_img}; a
        shorter one is padded by repeating its last row."""
        smax = max(d["x"].shape[0] for d in dicts)

        def pad(a):
            a = np.asarray(a, np.float32)
            if a.shape[0] == smax:
                return a
            return np.concatenate([a, np.repeat(a[-1:], smax - a.shape[0], axis=0)], 0)

        mask = np.zeros((len(dicts), smax), np.float32)
        for i, d in enumerate(dicts):
            mask[i, : d["x"].shape[0]] = 1.0
        t = lambda arrs: torch.tensor(np.stack(arrs), dtype=torch.float32, device=device)
        return cls(z_mu=t([pad(d["z_mu"]) for d in dicts]),
                   z_logvar=t([pad(d["z_var"]) for d in dicts]),
                   x=t([pad(d["x"]) for d in dicts]),
                   center=t([np.asarray(d["center"], np.float32) for d in dicts]),
                   center_img=t([np.asarray(d["center_img"], np.float32) for d in dicts]),
                   mask=t([mask[i] for i in range(len(dicts))]))


def calibrate_thresholds(fps: FingerprintSet, method: str = "L2"):
    """(thresh, clip) floats from the fingerprints' own separation: thresh
    is the least cross-fingerprint latent distance, clip twice the largest;
    with one fingerprint, the mean and twice the max of its positive
    within-fingerprint distances. One masked reduction over the (K*S)^2
    pair matrix; the two floats are its only host copies."""
    k, s, z = fps.z_mu.shape
    A = k * s
    mu, lv = fps.z_mu.reshape(A, z), fps.z_logvar.reshape(A, z)
    d = latent_distance(method, mu.repeat_interleave(A, 0), lv.repeat_interleave(A, 0),
                        mu.repeat(A, 1), lv.repeat(A, 1)).reshape(A, A)
    valid = fps.mask.reshape(A) > 0
    pair_ok = valid[:, None] & valid[None, :]
    inf = torch.full_like(d, float("inf"))
    if k > 1:
        fpid = torch.arange(k, device=d.device).repeat_interleave(s)
        cross = (fpid[:, None] != fpid[None, :]) & pair_ok
        lo_hi = torch.stack([torch.where(cross, d, inf).min(),
                             torch.where(cross, d, -inf).max()]).tolist()
        return lo_hi[0], lo_hi[1] * 2.0
    within = pair_ok & (d > 0)
    n = within.sum().clamp(min=1)
    mean_hi = torch.stack([torch.where(within, d, torch.zeros_like(d)).sum() / n,
                           torch.where(within, d, -inf).max()]).tolist()
    return mean_hi[0], mean_hi[1] * 2.0


def match_forward(model: CVAE, fps: FingerprintSet, test_y, test_force=None):
    """The test image decoded at every stored seed pose: one eval-mode
    forward of K*S rows. Returns the forward's outputs and the image rows
    it was given."""
    k, s, d = fps.x.shape
    seed_y = test_y[None].expand(k * s, *test_y.shape)
    force = None
    if model.learn_force:
        f = test_force if test_force is not None else test_y.new_zeros(1)
        force = f.reshape(1, 1).expand(k * s, 1)
    with torch.no_grad():
        out = model(fps.x.reshape(k * s, d), seed_y, force=force, train=False)
    return out, seed_y


def best_matches(out, seed_y, fps: FingerprintSet, dist_method: str = "L2",
                 error_mode: bool = False):
    """(best_dist (K,), best_seed_state (K, d)) from ``match_forward``'s
    outputs: the latent distance to each stored seed (or the reconstruction
    error with ``error_mode``), masked seeds at inf, best by ``argmin``."""
    k, s, d = fps.x.shape
    if error_mode:
        diff = out["img_pred"] - seed_y
        dists = torch.sqrt((diff ** 2).sum((1, 2, 3))).reshape(k, s)
    else:
        # rows of (K*S, z), so that L2 reduces each row, as per fingerprint
        z = fps.z_mu.shape[-1]
        dists = latent_distance(dist_method, fps.z_mu.reshape(k * s, z),
                                fps.z_logvar.reshape(k * s, z), out["z_mu"],
                                out["z_logvar"]).reshape(k, s)
    dists = torch.where(fps.mask > 0, dists, torch.full_like(dists, float("inf")))
    best = dists.argmin(1, keepdim=True)  # (K, 1)
    best_x = fps.x.gather(1, best[:, :, None].expand(k, 1, d))[:, 0]
    return dists.gather(1, best)[:, 0], best_x


def identify_step(model: CVAE, fps: FingerprintSet, test_x, test_y,
                  dist_method: str = "L2", error_mode: bool = False, test_force=None):
    """Match one observation against all fingerprints at once. Returns
    (best_dist (K,), best_seed_state (K, d)). ``test_x`` is not read: the
    image is decoded at the stored poses."""
    out, seed_y = match_forward(model, fps, test_y, test_force)
    return best_matches(out, seed_y, fps, dist_method, error_mode)


def _rz(a):
    c, s, z, o = torch.cos(a), torch.sin(a), torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def relative_pose_beliefs(states: str, test_state, fp_states, centers, robot_lim, tray_lim,
                          reflect_w: bool = True):
    """Relative-pose belief samples. With yaw among the states: yaw to tray
    angles, belief_xyz = test_xyz + (R_fp^T R_test)(center_xyz - fp_xyz),
    belief_w from R_fp^T R_center R_test, wrapped to [-pi, pi), optionally
    with the yaw reflection w + 2pi sign(w) appended, and yaw back to robot
    coordinates. Without yaw, test - fp + center. Returns (K or 2K, d)
    in the state order. Limits already on the device cost no copy."""
    dev = next((v.device for v in (test_state, fp_states, centers) if torch.is_tensor(v)),
               torch.device("cpu"))
    as_t = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    robot_lim, tray_lim = as_t(robot_lim), as_t(tray_lim)
    test_state = as_t(test_state)
    fp_states, centers = torch.atleast_2d(as_t(fp_states)), torch.atleast_2d(as_t(centers))
    if "w" not in states:
        return test_state[None, :] - fp_states + centers

    w_i = states.rfind("w")
    to_tray_w = lambda v: ws_conversion(v[..., None], robot_lim[w_i], tray_lim[w_i])[..., 0]
    to_robot_w = lambda v: ws_conversion(v[..., None], tray_lim[w_i], robot_lim[w_i])[..., 0]

    def xyz_of(v):
        """(..., d) state -> (..., 3) xyz, zeros for the absent ones."""
        return torch.stack([v[..., states.rfind(c)] if c in states
                            else v.new_zeros(v.shape[:-1]) for c in "xyz"], -1)

    fp_w = to_tray_w(fp_states[:, w_i])
    test_w = to_tray_w(test_state[w_i])
    fp_rot_t = _rz(fp_w).transpose(-1, -2)  # (K, 3, 3)
    test_rot = _rz(test_w.expand(fp_w.shape))
    mean_rot = _rz(to_tray_w(centers[:, w_i]))

    # without z among the states its column is zero on both sides
    diff = xyz_of(centers) - xyz_of(fp_states)  # (K, 3)
    test_xyz = xyz_of(test_state).expand(diff.shape)
    belief_xyz = test_xyz + torch.einsum("kij,kjl,kl->ki", fp_rot_t, test_rot, diff)
    comp = fp_rot_t @ mean_rot @ test_rot
    belief_w = torch.atan2(comp[:, 1, 0], comp[:, 0, 0])
    belief_w = (belief_w + torch.pi) % (2 * torch.pi) - torch.pi
    if reflect_w:
        refl = belief_w + 2 * torch.pi * torch.sign(belief_w)
        belief_xyz = torch.cat([belief_xyz, belief_xyz], 0)
        belief_w = torch.cat([belief_w, refl], 0)
    belief_w = to_robot_w(belief_w)

    cols = []
    for c in states:
        if c == "w":
            cols.append(belief_w)
        elif c in "xyz":
            cols.append(belief_xyz[:, "xyz".index(c)])
        else:
            cols.append(test_state[states.rfind(c)].expand(belief_w.shape))
    return torch.stack(cols, -1)


def fuse_matches(beliefs: list, dists, best_states, test_state, fps: FingerprintSet,
                 states: str, robot_lim, tray_lim, error_mode: bool = False,
                 reflect_w: bool = True):
    """Push each fingerprint's relative-pose sample(s) (with
    ``error_mode``, the test pose itself) with its best distance, and fuse.
    Returns the new beliefs."""
    if error_mode:
        return [b.push(test_state, dists[i]).update_prior() for i, b in enumerate(beliefs)]
    bel_states = relative_pose_beliefs(states, test_state, best_states, fps.center,
                                       robot_lim, tray_lim, reflect_w)
    k = fps.center.shape[0]
    new = []
    for i, b in enumerate(beliefs):
        for r in range(bel_states.shape[0] // k):  # 2 with the reflection
            b = b.push(bel_states[r * k + i], dists[i])
        new.append(b.update_prior())
    return new


def update_beliefs(model: CVAE, fps: FingerprintSet, beliefs: list, test_state, test_y,
                   states: str, robot_lim, tray_lim, dist_method: str = "L2",
                   error_mode: bool = False, reflect_w: bool = True, test_force=None):
    """One identification tick: match, compose the relative poses and fuse,
    for every fingerprint. Returns (new_beliefs, best_dists)."""
    dists, best_states = identify_step(model, fps, test_state, test_y, dist_method,
                                       error_mode, test_force)
    new = fuse_matches(beliefs, dists, best_states, test_state, fps, states, robot_lim,
                       tray_lim, error_mode, reflect_w)
    return new, dists

"""Entropy slices of the learned uncertainty field (port of
``ealv_tpu/fingerprint/entropy.py``): uniform samples over the plot plane
plus its four corners, crossed with a grid over every other state, the
model's uncertainty pdf under each of ``num_seeds`` replay seeds averaged,
renormalized and marginalized over the other states.

The seeds x (P*G) sweep is one batched encode of the seeds and one decode
of all their rows (times the 5 ring latents with ``use_z_ensemble``); only
the (P,) marginal comes to the host.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..models import CVAE
from ..models.cvae import LOGVAR_LIMS
from ..ops import renormalize


def _slice_lims(lims, lim_scale: float, pin):
    """Limits widened by ``lim_scale`` about their centres; ``pin = (dim,
    side)`` sets lims[dim, side] = 0 (side 0: the z >= 0 half-space, side
    1: z <= 0)."""
    lims = np.asarray(lims, np.float32).copy()
    span = (lims[:, 1] - lims[:, 0]) * (lim_scale - 1.0) / 2.0
    lims[:, 0] -= span
    lims[:, 1] += span
    if pin is not None:
        dim, side = pin
        lims[dim, side] = 0.0
    return lims


def _seed_pdfs(model: CVAE, xs, ys, fs, samples, use_z_ensemble: bool):
    """(S, M) uncertainty pdf at ``samples`` (M, d) of the model seeded
    from each of S samples, as ``CVAE.pdf`` after one ``update_dist`` from
    the initial state (whose z ring then holds the seed's latent and
    zeros)."""
    S, M = xs.shape[0], samples.shape[0]
    with torch.no_grad():
        z = model(xs, ys, force=fs if model.learn_force else None, train=False)["z"]
        zs = z[:, None]
        if use_z_ensemble:
            zs = torch.cat([zs, zs.new_zeros(S, model.z_mem - 1, z.shape[1])], 1)
        R = zs.shape[1]
        x = samples[None] - xs[:, None] if model.dx else samples[None].expand(S, M, -1)
        x = x[:, None].expand(S, R, M, -1).reshape(S * R * M, -1)
        zz = zs[:, :, None].expand(S, R, M, z.shape[1]).reshape(S * R * M, -1)
        _, y_logvar, _ = model.decode_fn(zz, x)
        y_logvar = y_logvar.reshape(S, R, M, -1).mean(1)
        return torch.exp(y_logvar.clamp(*LOGVAR_LIMS)).amax(-1)


def entropy_slice(model: CVAE, buf, lims, *, pin=None, plot_idx=(0, 1),
                  num_samples: int = 1000, num_seeds: int = 10, grid_pts: int = 10,
                  lim_scale: float = 1.15, use_z_ensemble: bool = False,
                  generator: torch.Generator | None = None, unit_plane=None, seed_idx=None):
    """One marginal uncertainty field over the ``plot_idx`` plane. The
    plane's unit draws (num_samples, 2) in [0, 1), scaled into the slice's
    limits, and the replay seed indices come from ``generator`` on the
    ring's device unless ``unit_plane`` and ``seed_idx`` feed them.
    Returns (plot samples (P, 2), marginal (P,)) as numpy, P = num_samples
    + 4."""
    d = len(lims)
    dev = buf.x.device
    lims = _slice_lims(lims, lim_scale, pin)
    plot_idx = list(plot_idx)
    other_idx = [i for i in range(d) if i not in plot_idx]
    lo, hi = (torch.as_tensor(lims[plot_idx, k], device=dev) for k in (0, 1))
    if unit_plane is None:
        unit_plane = torch.rand((num_samples, 2), generator=generator, device=dev)
    plane = torch.as_tensor(unit_plane, dtype=torch.float32, device=dev) * (hi - lo) + lo
    corners = torch.tensor(list(itertools.product(*lims[plot_idx])), dtype=torch.float32,
                           device=dev)
    plane = torch.cat([plane, corners])
    P = plane.shape[0]
    if other_idx:
        axes = [np.linspace(a, b, grid_pts, dtype=np.float32) for a, b in lims[other_idx]]
        others = torch.tensor(list(itertools.product(*axes)), device=dev)  # (G, n_other)
    else:
        others = torch.zeros((1, 0), device=dev)
    G = others.shape[0]
    full = torch.zeros((P, G, d), device=dev)
    full[:, :, plot_idx] = plane[:, None, :].expand(P, G, 2)
    if other_idx:
        full[:, :, other_idx] = others[None].expand(P, G, len(other_idx))

    if seed_idx is None:
        seed_idx = buf.sample_indices(num_seeds, weighted=False, generator=generator)
    seed_idx = torch.as_tensor(seed_idx, device=dev)
    pdfs = _seed_pdfs(model, buf.x[seed_idx], buf.y[seed_idx], buf.force[seed_idx],
                      full.reshape(P * G, d), use_z_ensemble)
    marginal = renormalize(pdfs.mean(0)).reshape(P, G).mean(1)
    return plane.cpu().numpy(), marginal.cpu().numpy()


def entropy_slices(model: CVAE, buf, lims, states: str, *, num_samples: int = 1000,
                   num_seeds: int = 10, generator: torch.Generator | None = None,
                   unit_plane=None, seed_idx=None, **kw):
    """Every variant: with a z state, posz (z >= 0), negz (z <= 0) and allz;
    otherwise one, 'all'. Returns {name: (plot samples, marginal)}. Every
    variant takes the same draws (drawn once here unless fed), as the
    reference draws them all from one key."""
    dev = buf.x.device
    if unit_plane is None:
        unit_plane = torch.rand((num_samples, 2), generator=generator, device=dev)
    if seed_idx is None:
        seed_idx = buf.sample_indices(num_seeds, weighted=False, generator=generator)
    kw.update(num_samples=num_samples, num_seeds=num_seeds, unit_plane=unit_plane,
              seed_idx=seed_idx)
    if "z" in states:
        z_idx = states.rfind("z")
        variants = [("posz", (z_idx, 0)), ("negz", (z_idx, 1)), ("allz", None)]
    else:
        variants = [("all", None)]
    return {name: entropy_slice(model, buf, lims, pin=pin, **kw) for name, pin in variants}

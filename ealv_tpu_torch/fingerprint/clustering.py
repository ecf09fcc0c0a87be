"""Object discovery (port of ``ealv_tpu/fingerprint/clustering.py``): score
candidate poses by the model's decoded variance under a batch of replay
seeds, resample toward the informative ones, cluster them (mean shift,
kmeans or a Gaussian mixture) and merge overlapping centres.

The seeds x samples scoring is one batched decode of S*N rows. Mean shift
is a fixed 30 iterations of tensor ops; the mode extraction, the merge,
kmeans (scipy) and the mixture (sklearn, imported only when asked for) run
on the host, as in the reference. Random draws come from a
``torch.Generator`` or are fed as ``ClusterDraws``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import CVAE
from ..ops import renormalize
from .identify import _encode_seed_z


def _decode_logvar(model: CVAE, z_seeds, seeds_x, samples):
    """y_logvar (S, N, v) of every sample under every seed's latent, as
    one decode of S*N rows."""
    S, N = z_seeds.shape[0], samples.shape[0]
    x = samples[None] - seeds_x[:, None, :] if model.dx else samples[None].expand(S, N, -1)
    z = z_seeds[:, None, :].expand(S, N, z_seeds.shape[1])
    _, y_logvar, _ = model.decode_fn(z.reshape(S * N, -1), x.reshape(S * N, -1))
    return y_logvar.reshape(S, N, -1)


def score_samples(model: CVAE, seeds_x, seeds_y, samples, seeds_force=None):
    """Mean decoded variance of ``samples`` (N, s_dim) under each seed's
    latent, averaged over the seeds and cubed: (N,) unnormalized
    objectness weights."""
    z_seeds = _encode_seed_z(model, seeds_x, seeds_y, seeds_force)
    with torch.no_grad():
        meas = torch.exp(_decode_logvar(model, z_seeds, seeds_x, samples)).mean(2)  # (S, N)
    return meas.mean(0) ** 3


def optimize_samples(model: CVAE, seeds_x, seeds_y, samples, barrier=None, seeds_force=None,
                     iters: int = 5, lr: float = 0.05, kernel_var: float = 1e-3,
                     pdf_weight: float = 12.0):
    """Kernel-repulsion optimization of the sample positions: Adam (optax's
    defaults) on  mean kernel(x_i, x_j) - w * sum_seeds mean renorm(pdf(x))
    + mean barrier(x), which pulls the samples toward uncertain regions
    while keeping them apart and inside the workspace. The gradient is with
    respect to the samples alone; the model's parameters get none."""
    z_seeds = _encode_seed_z(model, seeds_x, seeds_y, seeds_force)
    inv_var = 1.0 / kernel_var

    def loss_fn(pts):
        diff = pts[:, None, :] - pts[None, :, :]
        total = torch.exp(-0.5 * (diff ** 2).sum(-1) * inv_var).mean()
        pdf = torch.exp(_decode_logvar(model, z_seeds, seeds_x, pts)).amax(2)  # (S, N)
        total = total - pdf_weight * renormalize(pdf, dim=1).mean(1).sum()
        if barrier is not None:
            total = total + barrier.batch(pts).mean()
        return total

    pts = samples.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([pts], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(iters):
            pts.grad, = torch.autograd.grad(loss_fn(pts), [pts])
            opt.step()
    return pts.detach()


def reweight_resample(samples, weights, num_draws: int,
                      generator: torch.Generator | None = None, idx=None):
    """Weighted-to-unweighted resampling with replacement: ``num_draws``
    rows drawn in proportion to ``weights``, or the fed indices ``idx``."""
    if idx is None:
        idx = torch.multinomial(weights.clamp(min=1e-30), num_draws, replacement=True,
                                generator=generator)
    return samples[idx]


def mean_shift(X, bandwidth: float, iters: int = 30):
    """Fixed-iteration flat-kernel mean shift of every point of X (N, d)
    over X. Returns the shifted points (N, d)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    pts = X
    for _ in range(iters):
        d2 = ((pts[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        w = (d2 <= bandwidth ** 2).float()
        pts = (w @ X) / w.sum(1, keepdim=True).clamp(min=1e-9)
    return pts


def extract_modes(shifted, bandwidth: float, min_count: int = 10):
    """Converged points -> (cluster centres, labels), on the host: each
    point joins the earliest centre within bandwidth/2, else opens one;
    centres become their members' means, and clusters of fewer than
    ``min_count`` members are dropped (label -1)."""
    pts = np.asarray(shifted)
    n = pts.shape[0]
    close = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1) < (bandwidth / 2) ** 2
    center_idx: list[int] = []
    labels = np.full(n, -1, np.int64)
    for i in range(n):
        if center_idx:
            hits = np.nonzero(close[i, center_idx])[0]
            if hits.size:
                labels[i] = hits[0]
                continue
        center_idx.append(i)
        labels[i] = len(center_idx) - 1
    counts = np.bincount(labels, minlength=len(center_idx))
    keep = np.nonzero(counts >= min_count)[0]
    means = [pts[labels == j].mean(0) for j in keep]
    relabel = np.full(len(center_idx), -1, np.int64)
    relabel[keep] = np.arange(len(keep))
    labels = np.where(labels >= 0, relabel[labels], -1)
    return (np.array(means) if means else np.zeros((0, pts.shape[1]))), labels


def merge_overlapping(cluster_means, labels, sq_thresh: float = 0.04):
    """Drop the most-overlapping centre until every pair of centres is
    more than ``sq_thresh`` apart in squared distance."""
    means = np.asarray(cluster_means).copy()
    labels = np.asarray(labels).copy()
    while len(means) > 1:
        n = len(means)
        overlap = np.sum((means[None] - means[:, None]) ** 2, 2) + np.eye(n) < sq_thresh
        if not overlap.any():
            break
        drop = int(np.argmax(overlap.sum(1)))
        mapping = {old: new for new, old in enumerate(np.delete(np.arange(n), drop))}
        labels = np.array([mapping.get(l, -1) for l in labels])
        means = means[np.arange(n) != drop]
    return means, labels


class ClusterDraws(NamedTuple):
    """``find_clusters``' random draws, fed instead of drawn: the uniform
    samples (num_pts, s_dim), the resampling indices (num_pts // 2,) and,
    with ``get_blank``, the blank-region resampling indices."""

    samples: torch.Tensor
    resample_idx: torch.Tensor
    blank_idx: torch.Tensor | None = None


class ClusterResult(NamedTuple):
    means: np.ndarray  # (K, d)
    labels: np.ndarray  # (M,) -1 for outliers
    points: np.ndarray  # (M, d) the resampled points that were clustered
    blank_means: np.ndarray | None  # low-information regions


def find_clusters(model: CVAE, seeds_x, seeds_y, robot_lim, num_pts: int = 1000,
                  num_fingerprints: int = 2, plot_idx=(0, 1), cluster_method: str = "shift",
                  cluster_by_plot_idx: bool = True, bandwidth: float = 0.25,
                  scale: float = 1.0, get_blank: bool = False, seeds_force=None,
                  use_optimize_samples: bool = False, barrier=None,
                  generator: torch.Generator | None = None,
                  draws: ClusterDraws | None = None) -> ClusterResult:
    """Object discovery end to end: uniform samples in ``robot_lim`` *
    ``scale`` (optionally moved by ``optimize_samples`` and clipped back),
    scored, resampled, clustered and merged. Draws come from ``generator``
    on the seeds' device unless ``draws`` feeds them."""
    dev = seeds_x.device
    robot_lim = torch.as_tensor(np.asarray(robot_lim, np.float32), device=dev)
    lo, hi = robot_lim[:, 0], robot_lim[:, 1]
    if draws is not None:
        samples = draws.samples.to(dev)
    else:
        samples = torch.rand((num_pts, robot_lim.shape[0]), generator=generator,
                             device=dev) * (hi * scale - lo * scale) + lo * scale
    if use_optimize_samples:
        if barrier is not None and hasattr(barrier, "truncate"):
            barrier = barrier.truncate(samples.shape[1])
        samples = optimize_samples(model, seeds_x, seeds_y, samples, barrier=barrier,
                                   seeds_force=seeds_force)
        samples = torch.clamp(samples, lo, hi)
    weights = score_samples(model, seeds_x, seeds_y, samples, seeds_force)
    resampled = reweight_resample(samples, weights, num_pts // 2, generator,
                                  None if draws is None else draws.resample_idx.to(dev))
    cols = list(plot_idx)
    X = (resampled[:, cols] if cluster_by_plot_idx else resampled).cpu()

    if cluster_method == "shift":
        means, labels = extract_modes(mean_shift(X.to(dev), bandwidth).cpu().numpy(),
                                      bandwidth)
    elif cluster_method == "kmeans":
        from scipy.cluster.vq import kmeans2
        means, labels = kmeans2(X.numpy(), k=num_fingerprints, minit="points", seed=0)
    elif cluster_method == "gmm":
        from sklearn.mixture import GaussianMixture
        gmm = GaussianMixture(n_components=num_fingerprints, covariance_type="tied",
                              n_init=10).fit(X.numpy())
        means, labels = gmm.means_, gmm.predict(X.numpy())
    else:
        raise ValueError(f"unknown cluster method {cluster_method!r}")
    means, labels = merge_overlapping(means, labels)

    blank_means = None
    if get_blank:
        inv = -weights + weights.min() + weights.max()  # the avoid-dist flip
        blanks = reweight_resample(samples, inv, num_pts // 2, generator,
                                   None if draws is None else draws.blank_idx.to(dev))
        Xb = blanks[:, cols] if cluster_by_plot_idx else blanks
        blank_means, _ = extract_modes(mean_shift(Xb, bandwidth).cpu().numpy(), bandwidth)
    return ClusterResult(means=np.asarray(means), labels=np.asarray(labels),
                         points=X.numpy(), blank_means=blank_means)

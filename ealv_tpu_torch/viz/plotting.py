"""Offline figures (port of ``ealv_tpu/viz/plotting.py``): the exploration
dashboard, the training curves, the seed / actual / imagined evaluation
panels, the belief heatmaps, the entropy slices and the cluster figure,
drawn headless (Agg) from logged arrays into files; each returns the saved
path.

numpy and matplotlib; arrays may also be torch tensors (on any device).
matplotlib is imported at the first draw, not with the package: a machine
without it (the GPU machine has none) runs everything else, and a draw
there raises ``ImportError`` naming matplotlib.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported on first use."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the figures draw with matplotlib, which is not installed "
                          "here") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(a):
    """A numpy copy of an array or a tensor on any device (bf16 as f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def set_mpl_format():
    """The house style."""
    pyplot().rcParams.update({
        "font.size": 9,
        "axes.titlesize": 9,
        "axes.labelsize": 8,
        "figure.dpi": 120,
        "savefig.bbox": "tight",
    })


def _save(fig, dir_path, name):
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, name)
    fig.savefig(path)
    pyplot().close(fig)
    return path


class ExplorationPlotter:
    """Exploration dashboard: camera view, reconstruction, latent state,
    path, target vs time-averaged distribution, ergodic cost."""

    def __init__(self, dir_path: str, robot_lim=None):
        set_mpl_format()
        self.dir_path = dir_path
        self.robot_lim = _np(robot_lim) if robot_lim is not None else None

    def render(self, *, image, img_pred=None, z_mu=None, z_var=None,
               path_xy=None, samples=None, p=None, q=None, costs=None,
               step: int = 0, name: str | None = None):
        fig, axs = pyplot().subplots(2, 3, figsize=(10, 6))
        ax = axs[0, 0]
        ax.imshow(np.clip(_np(image), 0, 1))
        ax.set_title(f"sensor view (step {step})")
        ax.axis("off")

        ax = axs[0, 1]
        if img_pred is not None:
            ax.imshow(np.clip(_np(img_pred), 0, 1))
            ax.set_title("model reconstruction")
        ax.axis("off")

        ax = axs[0, 2]
        if z_mu is not None:
            z_mu = _np(z_mu)
            ax.bar(np.arange(len(z_mu)), z_mu,
                   yerr=np.sqrt(_np(z_var)) if z_var is not None else None,
                   color="tab:blue")
            ax.set_title("latent z (mu +- std)")

        ax = axs[1, 0]
        if samples is not None and p is not None:
            s = _np(samples)
            ax.tricontourf(s[:, 0], s[:, 1], _np(p), levels=20, cmap="viridis")
            ax.set_title("target dist p")
        if path_xy is not None:
            pa = _np(path_xy)
            ax.plot(pa[:, 0], pa[:, 1], "w.-", ms=2, lw=0.5)
        self._box(ax)

        ax = axs[1, 1]
        if samples is not None and q is not None:
            s = _np(samples)
            ax.tricontourf(s[:, 0], s[:, 1], _np(q), levels=20, cmap="magma")
            ax.set_title("time-averaged dist q")
        self._box(ax)

        ax = axs[1, 2]
        if costs is not None:
            ax.plot(_np(costs))
            ax.set_title("ergodic cost D_KL")
            ax.set_xlabel("explr step")

        return _save(fig, self.dir_path, name or f"explr_{step:05d}.png")

    def _box(self, ax):
        if self.robot_lim is not None:
            ax.set_xlim(self.robot_lim[0])
            ax.set_ylim(self.robot_lim[1])
        ax.set_aspect("equal", "box")


class TrainingPlotter:
    """Loss and schedule curves."""

    def __init__(self, dir_path: str):
        set_mpl_format()
        self.dir_path = dir_path

    def render(self, series: dict, name: str = "training.png"):
        keys = [k for k in ("loss", "rc", "kl", "rc_other", "beta", "gamma",
                            "ergodic_cost", "active_units")
                if k in series and len(np.ravel(series[k]))]
        n = max(len(keys), 1)
        fig, axs = pyplot().subplots((n + 2) // 3, 3, figsize=(10, 2.6 * ((n + 2) // 3)),
                                     squeeze=False)
        for ax, k in zip(axs.ravel(), keys):
            ax.plot(np.ravel(series[k]))
            ax.set_title(k)
        for ax in axs.ravel()[len(keys):]:
            ax.axis("off")
        return _save(fig, self.dir_path, name)


class EvalPlotter:
    """Seed / actual / imagined triptych and the latent bars."""

    def __init__(self, dir_path: str):
        set_mpl_format()
        self.dir_path = dir_path

    def render(self, seed_img, actual_img, imagined_img, z_mu=None, z_var=None,
               name: str = "eval.png"):
        fig, axs = pyplot().subplots(1, 4 if z_mu is not None else 3, figsize=(12, 3))
        for ax, img, title in zip(axs, [seed_img, actual_img, imagined_img],
                                  ["seed", "actual", "imagined"]):
            ax.imshow(np.clip(_np(img), 0, 1))
            ax.set_title(title)
            ax.axis("off")
        if z_mu is not None:
            ax = axs[-1]
            z_mu = _np(z_mu)
            ax.bar(np.arange(len(z_mu)), z_mu,
                   yerr=np.sqrt(_np(z_var)) if z_var is not None else None)
            ax.set_title("latent")
        return _save(fig, self.dir_path, name)


class MultiEvalPlotter:
    """Grid of seed / actual / imagined rows across several poses."""

    def __init__(self, dir_path: str):
        set_mpl_format()
        self.dir_path = dir_path

    def render(self, rows, name: str = "multi_eval.png"):
        """rows: list of (seed_img, actual_img, imagined_img[, label])."""
        n = len(rows)
        fig, axs = pyplot().subplots(n, 3, figsize=(7.5, 2.4 * n), squeeze=False)
        for r, row in enumerate(rows):
            label = row[3] if len(row) > 3 else f"pose {r}"
            for c, (img, title) in enumerate(zip(row[:3], ["seed", "actual", "imagined"])):
                ax = axs[r, c]
                ax.imshow(np.clip(_np(img), 0, 1))
                if r == 0:
                    ax.set_title(title)
                if c == 0:
                    ax.set_ylabel(label)
                ax.set_xticks([])
                ax.set_yticks([])
        return _save(fig, self.dir_path, name)


class BeliefPlotter:
    """Belief-grid heatmaps, one per fingerprint, marginalized over the
    angle dims."""

    def __init__(self, dir_path: str):
        set_mpl_format()
        self.dir_path = dir_path

    def render(self, beliefs, names=None, plot_idx=(0, 1), method: str = "mean",
               truth_xy=None, name: str = "beliefs.png"):
        from ..fingerprint.belief import marginalize_angles

        k = len(beliefs)
        fig, axs = pyplot().subplots(1, k, figsize=(4 * k, 3.6), squeeze=False)
        for i, (ax, b) in enumerate(zip(axs[0], beliefs)):
            grid_pdf = b.pdf_grid()
            marg = _np(marginalize_angles(grid_pdf, b.num_samples, plot_idx, method))
            lims = _np(b.lims)
            ax.imshow(marg, origin="lower", cmap="gist_heat",
                      extent=[*lims[plot_idx[0]], *lims[plot_idx[1]]], aspect="auto")
            peak = _np(b.grid)[int(np.argmax(_np(grid_pdf)))]
            ax.plot(peak[plot_idx[0]], peak[plot_idx[1]], "c*", ms=12, label="belief peak")
            if truth_xy is not None:
                ax.plot(truth_xy[i][0], truth_xy[i][1], "wo", mfc="none", ms=12,
                        label="truth")
            ax.set_title(names[i] if names else f"fingerprint {i}")
            ax.legend(loc="upper right", fontsize=6)
        return _save(fig, self.dir_path, name)


def plot_entropy_slices(dir_path, slices, prefix: str = "entropy_dist"):
    """One tricontourf of the marginal uncertainty field per z-range
    variant. ``slices`` is the {name: (plot_samples, marginal)} dict of
    ``fingerprint.entropy.entropy_slices``. Returns the saved paths."""
    set_mpl_format()
    paths = []
    for name, (samples, dist) in slices.items():
        fig, ax = pyplot().subplots(1, 1, figsize=(4, 4))
        s = _np(samples)
        ax.tricontourf(s[:, 0], s[:, 1], _np(dist), levels=30, cmap="gist_heat")
        ax.set_aspect("equal", "box")
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        fig.tight_layout()
        paths.append(_save(fig, dir_path, f"{prefix}_{name}.png"))
    return paths


def plot_clusters(dir_path, points, labels, means, samples=None, weights=None,
                  last_means=None, name: str = "clusters.png"):
    """Labeled points with the new (o) and old (^) centres, and the
    uncertainty field that produced them."""
    set_mpl_format()
    fig, axs = pyplot().subplots(1, 2, figsize=(8, 3.6))
    ax = axs[0]
    labels, pts = _np(labels), _np(points)
    for lbl in np.unique(labels):
        m = labels == lbl
        ax.scatter(pts[m, 0], pts[m, 1], s=4,
                   label=("outlier" if lbl < 0 else f"cluster {lbl}"))
    for mu in _np(means):
        ax.scatter(*mu[:2], marker="o", s=180, edgecolor="white", zorder=5)
    if last_means is not None:
        for mu in _np(last_means):
            ax.scatter(*mu[:2], marker="^", s=180, edgecolor="white", zorder=5)
    ax.set_title("clusters (o new, ^ old)")
    ax.legend(fontsize=6)

    ax = axs[1]
    if samples is not None and weights is not None:
        s = _np(samples)
        ax.tricontourf(s[:, 0], s[:, 1], _np(weights), levels=10, cmap="gist_heat")
    ax.set_title("uncertainty field")
    return _save(fig, dir_path, name)

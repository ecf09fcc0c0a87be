"""Live run dashboard (port of ``ealv_tpu/viz/dashboard.py``).

Every ``dash_every`` steps the run entry asks for one frame: ``payload``
gathers everything the frame shows (sensor view, reconstruction, latent
statistics, the gridded target and time-averaged distributions, path and
plan) on the device into one flat buffer, and copies it to the host in one
transfer, with no host wait before it, as the JAX payload is one jitted
program and one ``device_get``. ``render`` draws the frame with matplotlib
into ``dashboard.png``, replaced atomically, so a browser open on
``dashboard.html`` (or any viewer that re-reads the file) shows the run
live.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .plotting import pyplot, set_mpl_format

_HTML = """<!doctype html>
<html><head><meta http-equiv="refresh" content="2">
<title>ealv_tpu_torch live run</title></head>
<body style="background:#111;text-align:center">
<img src="dashboard.png" style="max-width:100%%">
</body></html>
"""


class LiveDashboard:
    """The live explore-and-learn dashboard of an ``Experiment``."""

    def __init__(self, exp, dir_path: str, grid: int = 50, plot_idx=(0, 1)):
        self.exp = exp
        self.dir_path = dir_path
        self.plot_idx = list(plot_idx)
        os.makedirs(dir_path, exist_ok=True)
        with open(os.path.join(dir_path, "dashboard.html"), "w") as f:
            f.write(_HTML)

        lim = np.asarray(exp.cfg.robot_lim, np.float32)[self.plot_idx]
        self.extent = [lim[0, 0], lim[0, 1], lim[1, 0], lim[1, 1]]
        xs = np.linspace(lim[0, 0], lim[0, 1], grid, dtype=np.float32)
        ys = np.linspace(lim[1, 0], lim[1, 1], grid, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        samp = np.zeros((grid * grid, len(exp.cfg.states)), np.float32)
        samp[:, self.plot_idx[0]] = gx.ravel()
        samp[:, self.plot_idx[1]] = gy.ravel()
        self.samples = torch.from_numpy(samp).to(exp.device)
        # a device index: a list index would be copied from pageable memory,
        # a copy that waits for the device
        self._plot_idx = torch.tensor(self.plot_idx, device=exp.device)
        self.grid = grid

    @torch.no_grad()
    def device_payload(self, es):
        """The frame's arrays on the device, as one flat float32 buffer and
        its layout [(name, shape)]; enqueues work and never waits for it.
        The planner's plot distributions make two K1 launches (the target's
        coverage spread and the footprint of memory plus plan); a baseline
        has neither."""
        exp, cfg = self.exp, self.exp.cfg
        _, _, force, img = exp.env.observe(es.env)
        x = exp._measured_robot_state(es.env)[: cfg.s_dim]
        y = img
        if cfg.image_dim[2] == 1 and y.shape[-1] != 1:
            y = y.mean(-1, keepdim=True)
        force_b = None
        if es.model.learn_force:
            force = force.float().reshape(-1)
            force_b = (torch.linalg.norm(force)[None] if force.shape[0] > 1 else force)[None]
        out = es.model(x[None], y[None], force=force_b, train=False)
        traj, mask = es.pstate.memory.get_all()
        parts = {"image": img, "img_pred": out["img_pred"][0], "z_mu": out["z_mu"][0],
                 "z_var": torch.exp(out["z_logvar"][0]), "path": traj, "path_mask": mask}
        if exp.use_baseline:
            parts["plan"], parts["cur"] = es.pstate.x[None, :], es.pstate.x
        else:
            parts["plan"], parts["cur"] = es.pstate.last_plan, es.pstate.dyn.x
            _, p, q = exp.planner.plot_dists(es.pstate, (es.model, es.mstate),
                                             self.samples, self._plot_idx)
            parts["p"] = p.reshape(self.grid, self.grid)
            parts["q"] = q.reshape(self.grid, self.grid)
        layout = [(k, tuple(v.shape)) for k, v in parts.items()]
        return torch.cat([v.float().reshape(-1) for v in parts.values()]), layout

    def payload(self, es) -> dict:
        """The frame's arrays as numpy, from one device-to-host copy."""
        flat, layout = self.device_payload(es)
        flat = flat.cpu().numpy()
        out, at = {}, 0
        for name, shape in layout:
            n = int(np.prod(shape, dtype=np.int64))
            out[name] = flat[at:at + n].reshape(shape)
            at += n
        return out

    def render(self, es, series=None, step: int = 0) -> str:
        """One dashboard frame; returns the png path. ``series`` is the
        ``MetricsLog.series`` dict (loss, ergodic_cost, beta, gamma)."""
        plt = pyplot()
        pl = self.payload(es)
        set_mpl_format()
        fig, axs = plt.subplots(2, 3, figsize=(11, 6.5))

        ax = axs[0, 0]
        ax.imshow(np.clip(pl["image"], 0, 1))
        ax.set_title(f"sensor view (step {step})")
        ax.axis("off")

        ax = axs[0, 1]
        rec = pl["img_pred"]
        ax.imshow(np.clip(rec if rec.shape[-1] != 1 else rec[..., 0], 0, 1),
                  cmap=None if rec.shape[-1] != 1 else "gray")
        ax.set_title("reconstruction")
        ax.axis("off")

        ax = axs[0, 2]
        ax.bar(np.arange(len(pl["z_mu"])), pl["z_mu"], yerr=np.sqrt(pl["z_var"]),
               color="tab:blue")
        ax.set_title("latent z (mu +- std)")

        i0, i1 = self.plot_idx
        path = pl["path"][pl["path_mask"] > 0]
        for col, key, cmap, title in ((0, "p", "viridis", "target dist p"),
                                      (1, "q", "magma", "time-averaged q")):
            ax = axs[1, col]
            if key in pl:
                ax.imshow(pl[key], origin="lower", cmap=cmap, extent=self.extent,
                          aspect="auto")
            if len(path):
                ax.plot(path[:, i0], path[:, i1], "w.", ms=2, alpha=0.6)
            ax.plot(pl["plan"][:, i0], pl["plan"][:, i1], "c.-", ms=3, lw=0.8)
            ax.plot(pl["cur"][i0], pl["cur"][i1], "gs", ms=8)
            ax.set_title(title)
            ax.set_xlim(self.extent[:2])
            ax.set_ylim(self.extent[2:])

        ax = axs[1, 2]
        if series:
            for k in ("ergodic_cost", "loss"):
                v = series.get(k)
                if v is not None and len(v):
                    vv = np.concatenate([np.atleast_1d(a) for a in v])
                    vv = vv[np.nonzero(vv)[0]] if k == "loss" else vv
                    if len(vv):
                        ax.plot(vv, label=k, lw=0.8)
            ax.legend(fontsize=6)
            ax.set_title("curves")
            ax.set_xlabel("explr step")

        tmp = os.path.join(self.dir_path, ".dashboard.tmp.png")
        final = os.path.join(self.dir_path, "dashboard.png")
        fig.savefig(tmp)
        plt.close(fig)
        os.replace(tmp, final)
        return final

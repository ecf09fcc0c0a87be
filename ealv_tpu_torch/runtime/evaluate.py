"""Offline evaluation of a CVAE on a collected test set (port of
``ealv_tpu/runtime/evaluate.py``): per-sample reconstruction MSE and NLL,
the latents and their active units over held-out data in one batched
forward, and "imagined" views (seed the model with one sample, decode at
other poses). Inputs are numpy arrays or tensors; results are numpy."""

from __future__ import annotations

import numpy as np
import torch

from ..models.cvae import CVAE, init_model_state, update_dist
from ..models.losses import gaussian_log_prob


def _on(model: CVAE, a):
    return torch.as_tensor(a, dtype=torch.float32, device=next(model.parameters()).device)


@torch.no_grad()
def evaluate_test_set(model: CVAE, poses, images, forces=None):
    """poses (N, s_dim) robot coords, images (N, H, W, C), forces (N, 1)
    (read only with ``learn_force``). Returns a dict of per-sample and mean
    reconstruction MSE and Gaussian NLL, z_mu, z_logvar, the active units
    (latent dims whose mean varies by more than 0.01 over the set) and the
    predicted images."""
    x, y = _on(model, poses), _on(model, images)
    force = _on(model, forces) if forces is not None and model.learn_force else None
    out = model(x, y, force=force, train=False)
    pred = out["img_pred"].float()
    mse = ((pred - y) ** 2).mean((1, 2, 3))
    nll = -gaussian_log_prob(y, pred, out["img_logvar"]).mean((1, 2, 3))
    z_mu = out["z_mu"].cpu().numpy()
    mse, nll = mse.cpu().numpy(), nll.cpu().numpy()
    return {
        "recon_mse": mse,
        "recon_nll": nll,
        "mean_mse": float(np.mean(mse)),
        "mean_nll": float(np.mean(nll)),
        "z_mu": z_mu,
        "z_logvar": out["z_logvar"].cpu().numpy(),
        "active_units": int((z_mu.var(axis=0) > 0.01).sum()),
        "img_pred": pred.cpu().numpy(),
    }


@torch.no_grad()
def imagined_views(model: CVAE, seed_pose, seed_image, query_poses, seed_force=None):
    """Seed the model with one (pose, image[, force]) and decode images at
    the query poses (M, s_dim). Returns (images (M, H, W, C), y_logvar (M,
    y_logvar_dim)) as numpy."""
    dev = next(model.parameters()).device
    mstate = init_model_state(model, dev)
    mstate, _ = update_dist(model, mstate, _on(model, seed_pose), _on(model, seed_image),
                            _on(model, seed_force) if seed_force is not None else None)
    y_logvar, feat = model.decode_samples(mstate, _on(model, query_poses))
    return (model.img_decode(feat).float().cpu().numpy(), y_logvar.cpu().numpy())


def eval_report(model: CVAE, test_set_path: str, dir_path: str, n_panels: int = 4):
    """The full offline report on a ``collect_test_set`` npz: the metrics of
    ``evaluate_test_set`` and ``n_panels`` seed / actual / imagined figures
    (``eval_{i}.png``: seeded with sample i, decoded at sample i + 1's
    pose). The set stores tray poses; they are mapped to the default
    config's robot coordinates, as in the JAX package. Returns the metrics."""
    from ..utils.config import ExperimentConfig
    from ..utils.states import ws_conversion
    from ..viz import EvalPlotter

    data = np.load(test_set_path)
    poses, images = data["poses"], data["images"]
    cfg = ExperimentConfig()
    poses_r = ws_conversion(torch.as_tensor(poses[:, cfg.sel()], dtype=torch.float32),
                            torch.as_tensor(cfg.tray_lim), torch.as_tensor(cfg.robot_lim))
    poses_r = poses_r.numpy()

    metrics = evaluate_test_set(model, poses_r, images)
    pl = EvalPlotter(dir_path)
    for i in range(min(n_panels, len(poses_r) - 1)):
        imagined, _ = imagined_views(model, poses_r[i], images[i], poses_r[i + 1:i + 2])
        pl.render(images[i], images[i + 1], imagined[0], z_mu=metrics["z_mu"][i],
                  z_var=np.exp(metrics["z_logvar"][i]), name=f"eval_{i}.png")
    return metrics

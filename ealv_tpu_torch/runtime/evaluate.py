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
    """The full offline report (metrics and seed/actual/imagined figure
    panels) needs the figure module's ``EvalPlotter``, which the port does
    not have yet."""
    raise NotImplementedError("eval_report draws with viz.EvalPlotter, which is not "
                              "ported yet; evaluate_test_set and imagined_views are")

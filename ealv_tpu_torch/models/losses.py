"""CVAE training losses (port of ``ealv_tpu/models/losses.py``): Gaussian
NLL with std = exp(y_logvar), KL to a unit Gaussian, and the weighted
objective RC + beta*KL (+ force) + gamma_weight*gamma*cross-decode, where
the force variant adds the force NLL and its cross-decode counterpart."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = math.log(math.sqrt(2.0 * math.pi))


def gaussian_log_prob(y, y_pred, y_logvar):
    """Elementwise log N(y | y_pred, exp(y_logvar)^2); y (B, H, W, C),
    y_logvar (B, v) broadcast over H, W. Both images are upcast to f32."""
    if y_logvar.ndim != y.ndim:
        y_logvar = y_logvar.reshape(y_logvar.shape[0], *([1] * (y.ndim - 2)), -1)
    y_pred = y_pred.float()
    y = y.float()
    var = torch.exp(y_logvar) ** 2
    return -(y - y_pred) ** 2 / (2.0 * var) - y_logvar - _LOG_SQRT_2PI


def gaussian_nll(y, y_pred, y_logvar):
    """-mean log N(y | y_pred, exp(y_logvar)^2)."""
    return -gaussian_log_prob(y, y_pred, y_logvar).mean()


def kl_divergence(z_mu, z_logvar):
    """-mean_B 0.5 sum_z (1 + logvar - mu^2 - exp(logvar))."""
    return -(0.5 * (1.0 + z_logvar - z_mu ** 2 - torch.exp(z_logvar)).sum(1)).mean()


def cvae_loss(out: dict, y, y2=None, beta=0.0, gamma=0.0,
              gamma_weight: float = 0.1, other_locs: bool = False,
              force=None, force2=None, learn_force: bool = False):
    """Full objective; ``force``/``force2`` (B, 1) are the targets of the
    force head at the sample's and the cross-decode's pose. Returns (loss,
    metrics dict)."""
    rc = gaussian_nll(y, out["img_pred"], out["img_logvar"])
    kl = kl_divergence(out["z_mu"], out["z_logvar"])
    loss = rc + beta * kl
    metrics = {"rc": rc, "kl": kl}
    if learn_force:
        f_loss = gaussian_nll(force, out["force_pred"], out["force_logvar"])
        loss = loss + f_loss
        metrics["force"] = f_loss
    if other_locs:
        rc_o = gaussian_nll(y2, out["img_pred_decode"], out["img_logvar_decode"])
        other = gamma * rc_o
        if learn_force:
            other = other + gamma * gaussian_nll(force2, out["force_pred_decode"],
                                                 out["force_logvar_decode"])
        loss = loss + other * gamma_weight
        metrics["rc_other"] = rc_o
    metrics["loss"] = loss
    return loss, metrics

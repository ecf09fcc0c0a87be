"""Latent-space distances between diagonal Gaussians (port of
``ealv_tpu/fingerprint/distances.py``): L2 on the means, the negative mean
log-prob, KL(N1 || N2) and the Bhattacharyya distance."""

from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = math.log(math.sqrt(2.0 * math.pi))


def latent_distance(method: str, z1_mu, z1_logvar, z2_mu, z2_logvar):
    """Distance between N(z1_mu, diag exp(z1_logvar)) and N(z2_mu, ...).

    ``method`` is matched by substring ('L2', 'logprob', 'KL', 'BC'). L2
    reduces over every axis but the first; the others over the last axis
    and broadcast over the leading ones.
    """
    diff = z1_mu - z2_mu
    if "L2" in method:
        sq = diff ** 2
        dims = tuple(range(1, diff.ndim))
        return torch.sqrt(sq.sum(dims) if dims else sq)
    if "logprob" in method:
        # exp(logvar) is the Normal's scale, as in the reference
        var = torch.exp(z1_logvar) ** 2
        log_prob = -(diff ** 2) / (2 * var) - z1_logvar - _LOG_SQRT_2PI
        return -log_prob.mean(-1)
    z1_var = torch.exp(z1_logvar)
    z2_var = torch.exp(z2_logvar)
    if "KL" in method:
        mu_diff = ((z1_var + diff ** 2) / (2 * z2_var)).sum(-1)
        var_diff = (z2_logvar / 2 - z1_logvar / 2).sum(-1)
        return var_diff + mu_diff - 0.5 * diff.shape[-1]
    if "BC" in method:
        mu_diff = (diff ** 2 / (z1_var + z2_var)).sum(-1)
        var_prod = (torch.log((z1_var + z2_var) / 2) - z1_logvar / 2 - z2_logvar / 2).sum(-1)
        return 0.25 * mu_diff + 0.5 * var_prod
    raise ValueError(f"requested method {method!r} not defined")

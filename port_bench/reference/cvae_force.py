"""The force sensor-object CVAE and its z-ensemble target in plain torch:
``cvae.py``'s copy of the default path widened by the contact force, as
the port's ``ealv_tpu_torch/models/cvae.py`` runs it with ``learn_force``
and ``use_z_ensemble`` (the published ``vae/vae_force.py:157-197`` and
``vae/vae.py:134-138,244-275``).

The encoder reads [image features | force | pose]; the decoder's head
emits [y_logvar | force_pred | image features], and the force shares the
image's log-variance. ``ensemble`` decodes the target under every latent
of the z ring in one batch of ``z_mem`` x N rows and averages the
log-variance over the ring (the port averages the image features too and
throws them away: nothing reads them). Casts as in ``cvae.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cvae import CVAE, LOGVAR_LIMS, ModelState, no_cast


class ForceCVAE(CVAE):
    """``CVAE`` with the force channel and, with ``ensemble``, the ensemble
    target."""

    def __init__(self, img_dim, z_dim=16, s_dim=2, hidden_dim=(512, 256),
                 cnn_kernels=(3, 3, 5), cnn_strides=(2, 2, 3), cnn_channels=(10, 10, 20),
                 y_logvar_dim=1, z_mem=5, cast=no_cast, ensemble: bool = False):
        super().__init__(img_dim, z_dim, s_dim, hidden_dim, cnn_kernels, cnn_strides,
                         cnn_channels, y_logvar_dim, z_mem, cast)
        self.ensemble = ensemble
        # the force widens both; the same places in the module order, so the
        # seed's draws fall alike
        self.encode = self._mlp([self.feat_dim + 1 + s_dim, *hidden_dim, 2 * z_dim])
        self.decode = self._mlp([z_dim + s_dim, *reversed(hidden_dim),
                                 y_logvar_dim + 1 + self.feat_dim])

    def encode_fn(self, x, y, force):
        c = self.cast
        h = torch.cat([self.img_encode(y), c(force), c(x)], 1)
        fcs = [m for m in self.encode if isinstance(m, torch.nn.Linear)]
        for fc in fcs[:-1]:
            h = F.relu(self._linear(fc, h))
        out = self._linear(fcs[-1], h).float()
        z_mu, z_logvar = out[:, : self.z_dim], out[:, self.z_dim:]
        return z_mu, z_logvar.clamp(*LOGVAR_LIMS)

    def decode_fn(self, z, x):
        """(img_feat, y_logvar f32, force_pred f32 (B, 1))."""
        h = torch.cat([z, x], 1)
        fcs = [m for m in self.decode if isinstance(m, torch.nn.Linear)]
        for fc in fcs[:-1]:
            h = F.relu(self._linear(fc, h))
        out = self._linear(fcs[-1], h)
        v = self.y_logvar_dim
        return out[:, v + 1:], out[:, :v].float().clamp(*LOGVAR_LIMS), out[:, v:v + 1].float()

    def forward(self, x, y, force, x_decode=None, train=False, generator=None):
        """As ``CVAE.forward``, with ``force`` (B, 1) into the encoder and
        the force head's prediction, with the image's log-variance, out."""
        z_mu, z_logvar = self.encode_fn(x, y, force)
        if train:
            eps = torch.randn(z_mu.shape, generator=generator, device=z_mu.device)
            z = z_mu + eps * torch.exp(0.5 * z_logvar)
        else:
            z = z_mu
        out = dict(z_mu=z_mu, z_logvar=z_logvar, z=z)
        if x_decode is not None:
            b = x.shape[0]
            feat, y_logvar, f = self.decode_fn(torch.cat([z, z], 0), torch.cat([x, x_decode], 0))
            img = self.img_decode(feat)
            out.update(img_pred=img[:b], img_logvar=y_logvar[:b], force_pred=f[:b],
                       force_logvar=y_logvar[:b], img_pred_decode=img[b:],
                       img_logvar_decode=y_logvar[b:], force_pred_decode=f[b:],
                       force_logvar_decode=y_logvar[b:])
            return out
        feat, y_logvar, f = self.decode_fn(z, x)
        out.update(img_pred=self.img_decode(feat), img_logvar=y_logvar, force_pred=f,
                   force_logvar=y_logvar)
        return out

    @torch.no_grad()
    def pdf(self, state: ModelState, samples, ensemble: bool | None = None):
        """exp(y_logvar) max over channels at each candidate pose, decoded
        under the current latent or, with ``ensemble`` (the model's own
        unless given), under each latent of the ring and averaged; uniform
        before the first sample."""
        ensemble = self.ensemble if ensemble is None else ensemble
        n = samples.shape[0]
        if ensemble:
            zs = state.z_buff[:, None, :].expand(self.z_mem, n, self.z_dim)
            xs = samples[None].expand(self.z_mem, *samples.shape)
            _, y_logvar, _ = self.decode_fn(zs.reshape(-1, self.z_dim),
                                            xs.reshape(-1, samples.shape[1]))
            y_logvar = y_logvar.reshape(self.z_mem, n, -1).mean(0)
        else:
            _, y_logvar, _ = self.decode_fn(state.z[None, :].expand(n, self.z_dim), samples)
        var = torch.exp(y_logvar.clamp(*LOGVAR_LIMS)).amax(1)
        return torch.where(state.initialized, var, torch.ones_like(var))


@torch.no_grad()
def update_dist(model: ForceCVAE, state: ModelState, x, y, force) -> ModelState:
    """Re-seed the target from the latest sample, its force (1,) into the
    encoder, and shift its latent into the z ring."""
    z = model.encode_fn(x[None], y[None], force[None])[0][0]
    return ModelState(seed_x=x, seed_y=y.float(), seed_force=force, z=z,
                      z_buff=torch.cat([z[None], state.z_buff[:-1]], 0),
                      initialized=torch.ones((), dtype=torch.bool, device=x.device))

"""The conditional VAE in plain torch: a frozen copy of the default path of
``ealv_tpu_torch/models/cvae.py`` (the ``"conv_transpose"`` decoder, the
library's conv weight gradients, native channel counts).

Where the program casts a conv's or a linear layer's input, weight and bias
to its compute dtype, this copy calls ``cast``: for the reference the cast
to the compute dtype that the configuration states (``CASTS``), for the
control a rounding to the precision below it (``fp8_round``). The
parameters stay float32 either way.
Images are NHWC ``(B, H, W, C)``; the convs run NCHW and the conv features
flatten in (C, h, w) order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .config import conv_output_dims

LOGVAR_LIMS = (-10.0, 2.0)
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def no_cast(x):
    return x


def bf16_round(x):
    """``x`` in bfloat16: the products run in bfloat16, as the
    configuration's ``compute_dtype`` states."""
    return x.to(torch.bfloat16)


def fp8_round(x):
    """``x`` rounded to float8 e4m3 under one scale per tensor (its largest
    magnitude onto e4m3's largest finite value), returned in float32: the
    inputs of an fp8 product with float32 accumulation."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


# the reference's cast for each compute dtype a configuration may state
CASTS = {"float32": no_cast, "bfloat16": bf16_round}


@dataclasses.dataclass
class ModelState:
    seed_x: torch.Tensor  # (s_dim,)
    seed_y: torch.Tensor  # (H, W, C) f32
    seed_force: torch.Tensor  # (1,)
    z: torch.Tensor  # (z_dim,)
    z_buff: torch.Tensor  # (z_mem, z_dim)
    initialized: torch.Tensor  # () bool


class CVAE(nn.Module):
    """encoder: conv(img) -> flatten -> MLP([feat, pose]) -> (mu, logvar);
    decoder: MLP([z, pose]) -> [y_logvar | img_feat] -> conv_transpose ->
    image."""

    def __init__(self, img_dim, z_dim=16, s_dim=2, hidden_dim=(512, 256),
                 cnn_kernels=(3, 3, 5), cnn_strides=(2, 2, 3), cnn_channels=(10, 10, 20),
                 y_logvar_dim=1, z_mem=5, cast=no_cast):
        super().__init__()
        self.img_dim = tuple(img_dim)
        self.z_dim, self.s_dim, self.y_logvar_dim, self.z_mem = z_dim, s_dim, y_logvar_dim, z_mem
        self.cast = cast
        (h, w), dims = conv_output_dims(self.img_dim[:2], cnn_kernels, cnn_strides)
        self.inner_shape = (cnn_channels[-1], h, w)
        self.feat_dim = h * w * cnn_channels[-1]
        in_ch = [self.img_dim[2]] + list(cnn_channels[:-1])
        enc = []
        for i, (k, s, c) in enumerate(zip(cnn_kernels, cnn_strides, cnn_channels)):
            if i:
                enc.append(nn.ReLU())
            enc.append(nn.Conv2d(in_ch[i], c, k, stride=s))
        self.img_encoder = nn.Sequential(*enc)
        self.encode = self._mlp([self.feat_dim + s_dim, *hidden_dim, 2 * z_dim])
        self.decode = self._mlp([z_dim + s_dim, *reversed(hidden_dim),
                                 y_logvar_dim + self.feat_dim])
        L = len(cnn_kernels)
        dec = [nn.Unflatten(1, self.inner_shape)]
        self.output_padding = []
        for i, (k, s, c_in, c_out) in enumerate(zip(
                reversed(cnn_kernels), reversed(cnn_strides),
                reversed(cnn_channels), reversed(in_ch))):
            in_hw, target = dims[L - i], dims[L - 1 - i]
            op = tuple(target[d] - ((in_hw[d] - 1) * s + k) for d in range(2))
            if i:
                dec.append(nn.ReLU())
            dec.append(nn.ConvTranspose2d(c_in, c_out, k, stride=s, output_padding=op))
            self.output_padding.append(op)
        self.img_decoder = nn.Sequential(*dec)

    @staticmethod
    def _mlp(widths):
        layers = []
        for i in range(len(widths) - 1):
            if i:
                layers.append(nn.ReLU())
            layers.append(nn.Linear(widths[i], widths[i + 1]))
        return nn.Sequential(*layers)

    def reset_parameters(self, generator: torch.Generator):
        """flax's defaults: lecun-normal (truncated) weights, zero biases."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                    w = m.weight
                    fan_in = w.shape[1] if isinstance(m, nn.Linear) else (
                        w[0].numel() if isinstance(m, nn.Conv2d)
                        else w.shape[0] * w.shape[2] * w.shape[3])
                    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                    nn.init.zeros_(m.bias)

    def _linear(self, fc, h):
        c = self.cast
        return F.linear(c(h), c(fc.weight), c(fc.bias))

    def img_encode(self, y):
        c = self.cast
        h = c(y).permute(0, 3, 1, 2)
        convs = [m for m in self.img_encoder if isinstance(m, nn.Conv2d)]
        for i, conv in enumerate(convs):
            h = F.conv2d(c(h), c(conv.weight), c(conv.bias), stride=conv.stride[0])
            if i < len(convs) - 1:
                h = F.relu(h)
        return h.flatten(1)

    def img_decode(self, feat):
        c = self.cast
        h = feat.reshape(feat.shape[0], *self.inner_shape)
        convs = [m for m in self.img_decoder if isinstance(m, nn.ConvTranspose2d)]
        for i, (conv, op) in enumerate(zip(convs, self.output_padding)):
            h = F.conv_transpose2d(c(h), c(conv.weight), c(conv.bias),
                                   stride=conv.stride[0], output_padding=op)
            if i < len(convs) - 1:
                h = F.relu(h)
        return h.permute(0, 2, 3, 1)

    def encode_fn(self, x, y):
        h = torch.cat([self.img_encode(y), self.cast(x)], 1)
        fcs = [m for m in self.encode if isinstance(m, nn.Linear)]
        for fc in fcs[:-1]:
            h = F.relu(self._linear(fc, h))
        out = self._linear(fcs[-1], h).float()
        z_mu, z_logvar = out[:, : self.z_dim], out[:, self.z_dim:]
        return z_mu, z_logvar.clamp(*LOGVAR_LIMS)

    def decode_fn(self, z, x):
        """(img_feat, y_logvar f32)."""
        h = torch.cat([z, x], 1)
        fcs = [m for m in self.decode if isinstance(m, nn.Linear)]
        for fc in fcs[:-1]:
            h = F.relu(self._linear(fc, h))
        out = self._linear(fcs[-1], h)
        v = self.y_logvar_dim
        return out[:, v:], out[:, :v].float().clamp(*LOGVAR_LIMS)

    def forward(self, x, y, x_decode=None, train=False, generator=None):
        """Full forward pass; with ``train`` the latent is reparameterized
        with noise from ``generator``; with ``x_decode`` the cross-decode
        at the second pose runs in the same decoder batch (2B rows)."""
        z_mu, z_logvar = self.encode_fn(x, y)
        if train:
            eps = torch.randn(z_mu.shape, generator=generator, device=z_mu.device)
            z = z_mu + eps * torch.exp(0.5 * z_logvar)
        else:
            z = z_mu
        out = dict(z_mu=z_mu, z_logvar=z_logvar, z=z)
        if x_decode is not None:
            b = x.shape[0]
            feat, y_logvar = self.decode_fn(torch.cat([z, z], 0), torch.cat([x, x_decode], 0))
            img = self.img_decode(feat)
            out.update(img_pred=img[:b], img_logvar=y_logvar[:b],
                       img_pred_decode=img[b:], img_logvar_decode=y_logvar[b:])
            return out
        feat, y_logvar = self.decode_fn(z, x)
        out.update(img_pred=self.img_decode(feat), img_logvar=y_logvar)
        return out

    @torch.no_grad()
    def pdf(self, state: ModelState, samples):
        """exp(y_logvar) max over channels at each candidate pose, decoded
        with the current z seed; uniform before the first sample."""
        n = samples.shape[0]
        _, y_logvar = self.decode_fn(state.z[None, :].expand(n, self.z_dim), samples)
        var = torch.exp(y_logvar.clamp(*LOGVAR_LIMS)).amax(1)
        return torch.where(state.initialized, var, torch.ones_like(var))


def init_model_state(model: CVAE, device) -> ModelState:
    h, w, c = model.img_dim
    return ModelState(
        seed_x=torch.zeros(model.s_dim, device=device),
        seed_y=torch.zeros((h, w, c), device=device),
        seed_force=torch.zeros(1, device=device),
        z=torch.zeros(model.z_dim, device=device),
        z_buff=torch.zeros((model.z_mem, model.z_dim), device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device))


@torch.no_grad()
def update_dist(model: CVAE, state: ModelState, x, y, force) -> ModelState:
    """Re-seed the target distribution from the latest sample and shift its
    latent into the z ring."""
    z = model(x[None], y[None], train=False)["z"][0]
    return ModelState(seed_x=x, seed_y=y.float(), seed_force=force, z=z,
                      z_buff=torch.cat([z[None], state.z_buff[:-1]], 0),
                      initialized=torch.ones((), dtype=torch.bool, device=x.device))

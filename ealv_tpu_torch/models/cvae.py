"""Conditional VAE in torch (port of ``ealv_tpu/models/cvae.py``).

Only the default ``conv_transpose`` decoder is built. The module keeps the
reference torch key layout (``img_encoder.{2i}``, ``encode.{2i}``,
``decode.{2i}``, ``img_decoder.{2i+1}``), so
``ealv_tpu/utils/torch_import.py::convert_state_dict`` reads its
``state_dict`` as it is, the force variant's (``learn_force``) included.
Public tensors keep the JAX layouts: images are
NHWC ``(B, H, W, C)``; internally the convs run NCHW and the conv features
flatten in (C, h, w) order.

Compute dtype: like flax's ``dtype=``, every conv and linear layer casts
its input, weight and bias to ``compute_dtype`` while the parameters stay
f32. The encoder head is upcast to f32, the decoder's image features stay
in the compute dtype, and only the small logvar head is upcast. These
casts are written out; autocast is not used because it casts elsewhere.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fast_conv import conv2d_valid_direct
from ..utils.config import conv_output_dims

LOGVAR_LIMS = (-10.0, 2.0)


@dataclasses.dataclass
class ModelState:
    """Target-distribution state: the latest sample, its latent and the
    ring of the last ``z_mem`` latents (newest in row 0) that the
    z-ensemble decodes under."""

    seed_x: torch.Tensor  # (s_dim,)
    seed_y: torch.Tensor  # (H, W, C) f32
    seed_force: torch.Tensor  # (1,)
    z: torch.Tensor  # (z_dim,)
    z_buff: torch.Tensor  # (z_mem, z_dim)
    initialized: torch.Tensor  # () bool


class CVAE(nn.Module):
    """Image (and, with ``learn_force``, contact force) conditioned on pose.

    encoder: conv(img) -> flatten -> MLP([feat, (force,) pose]) -> (mu, logvar)
    decoder: MLP([z, pose]) -> [y_logvar | (force_pred |) img_feat]
             -> conv_transpose(img_feat) -> image
    The force shares the image's logvar (the "combo var").
    """

    def __init__(self, img_dim, z_dim: int = 16, s_dim: int = 2,
                 hidden_dim=(512, 256), cnn_kernels=(3, 3, 5),
                 cnn_strides=(2, 2, 3), cnn_channels=(10, 10, 20),
                 y_logvar_dim: int = 1, learn_force: bool = False,
                 dx: bool = False, z_mem: int = 5, compute_dtype=torch.float32,
                 decoder_mode: str = "conv_transpose",
                 fast_encoder_grads=False, lane_pad: int = 0):
        super().__init__()
        if decoder_mode != "conv_transpose":
            raise NotImplementedError(f"decoder_mode={decoder_mode!r}: the port "
                                      "builds only 'conv_transpose'")
        if fast_encoder_grads not in (False, "pallas"):
            raise NotImplementedError(f"fast_encoder_grads={fast_encoder_grads!r}: "
                                      "the port builds only False and 'pallas'")
        if lane_pad:
            raise NotImplementedError("lane_pad is not ported")
        self.img_dim = tuple(img_dim)
        self.z_dim = z_dim
        self.s_dim = s_dim
        self.y_logvar_dim = y_logvar_dim
        self.learn_force = learn_force
        self.force_dim = 1 if learn_force else 0
        self.dx = dx
        self.z_mem = z_mem
        self.compute_dtype = compute_dtype
        self.fast_encoder_grads = fast_encoder_grads
        (h, w), dims = conv_output_dims(self.img_dim[:2], cnn_kernels, cnn_strides)
        self.inner_shape = (cnn_channels[-1], h, w)  # NCHW
        self.feat_dim = h * w * cnn_channels[-1]

        in_ch = [self.img_dim[2]] + list(cnn_channels[:-1])
        enc = []
        for i, (k, s, c) in enumerate(zip(cnn_kernels, cnn_strides, cnn_channels)):
            if i:
                enc.append(nn.ReLU())
            enc.append(nn.Conv2d(in_ch[i], c, k, stride=s))
        self.img_encoder = nn.Sequential(*enc)
        self.encode = self._mlp([self.feat_dim + self.force_dim + s_dim, *hidden_dim,
                                 2 * z_dim])
        self.decode = self._mlp([z_dim + s_dim, *reversed(hidden_dim),
                                 y_logvar_dim + self.force_dim + self.feat_dim])
        # a VALID transposed conv of a floor-divided forward conv comes up
        # `deficit` pixels short; output_padding adds them at the hi edge,
        # as the JAX decoder's (k-1, k-1+deficit) padding does
        L = len(cnn_kernels)
        # the Unflatten at index 0 puts the transposed convs at the reference
        # keys img_decoder.{1,3,5}
        dec = [nn.Unflatten(1, self.inner_shape)]
        self.output_padding = []
        for i, (k, s, c_in, c_out) in enumerate(zip(
                reversed(cnn_kernels), reversed(cnn_strides),
                reversed(cnn_channels), reversed(in_ch))):
            in_hw, target = dims[L - i], dims[L - 1 - i]
            op = tuple(target[d] - ((in_hw[d] - 1) * s + k) for d in range(2))
            if i:
                dec.append(nn.ReLU())
            dec.append(nn.ConvTranspose2d(c_in, c_out, k, stride=s,
                                          output_padding=op))
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
                    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    nn.init.zeros_(m.bias)

    # ---------- sub-networks ----------

    def _layers(self, seq, cls):
        return [m for m in seq if isinstance(m, cls)]

    def _linear(self, fc, h):
        dt = self.compute_dtype
        return F.linear(h, fc.weight.to(dt), fc.bias.to(dt))

    def img_encode(self, y):
        """(B, H, W, C) -> (B, feat), features in (C, h, w) order. The last
        conv is not activated. With ``fast_encoder_grads="pallas"`` each conv
        takes its weight gradient from K3 (``ops/fast_conv.py``) and the bias
        is added after it, as the JAX ``_FastValidConv`` does."""
        dt = self.compute_dtype
        h = y.to(dt).permute(0, 3, 1, 2)
        convs = self._layers(self.img_encoder, nn.Conv2d)
        for i, conv in enumerate(convs):
            if self.fast_encoder_grads == "pallas":
                h = conv2d_valid_direct(h, conv.weight.to(dt), conv.stride[0]) \
                    + conv.bias.to(dt)[:, None, None]
            else:
                h = F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), stride=conv.stride)
            if i < len(convs) - 1:
                h = F.relu(h)
        return h.flatten(1)

    def img_decode(self, feat):
        """(B, feat) -> (B, H, W, C) in the compute dtype."""
        dt = self.compute_dtype
        h = feat.reshape(feat.shape[0], *self.inner_shape)
        convs = self._layers(self.img_decoder, nn.ConvTranspose2d)
        for i, (conv, op) in enumerate(zip(convs, self.output_padding)):
            h = F.conv_transpose2d(h, conv.weight.to(dt), conv.bias.to(dt),
                                   stride=conv.stride, output_padding=op)
            if i < len(convs) - 1:
                h = F.relu(h)
        return h.permute(0, 2, 3, 1)

    def encode_fn(self, x, y, force=None):
        parts = [self.img_encode(y)]
        if self.learn_force:
            parts.append(force.to(self.compute_dtype))
        h = torch.cat(parts + [x.to(self.compute_dtype)], 1)
        fcs = self._layers(self.encode, nn.Linear)
        for fc in fcs[:-1]:
            h = F.relu(self._linear(fc, h))
        out = self._linear(fcs[-1], h).float()
        z_mu, z_logvar = out[:, : self.z_dim], out[:, self.z_dim:]
        return z_mu, z_logvar.clamp(*LOGVAR_LIMS)

    def decode_fn(self, z, x):
        """(B, z), (B, s) -> (img_feat in the compute dtype, y_logvar f32,
        force_pred f32 (B, 1)); force_pred is zeros without ``learn_force``."""
        h = torch.cat([z, x], 1).to(self.compute_dtype)
        fcs = self._layers(self.decode, nn.Linear)
        for fc in fcs[:-1]:
            h = F.relu(self._linear(fc, h))
        out = self._linear(fcs[-1], h)
        v = self.y_logvar_dim
        y_logvar = out[:, :v].float().clamp(*LOGVAR_LIMS)
        if self.learn_force:
            return out[:, v + 1:], y_logvar, out[:, v:v + 1].float()
        return out[:, v:], y_logvar, out.new_zeros((out.shape[0], 1), dtype=torch.float32)

    # ---------- public API ----------

    def forward(self, x, y, force=None, x_decode=None, train: bool = False, eps=None,
                generator: torch.Generator | None = None):
        """Full forward pass; ``force`` (B, 1) feeds the encoder with
        ``learn_force``. With ``train`` the latent is reparameterized with
        ``eps`` (B, z_dim), or with noise drawn from ``generator``. With
        ``x_decode`` the cross-decode at the second pose runs in the same
        batched decoder pass (2B rows)."""
        z_mu, z_logvar = self.encode_fn(x, y, force)
        if train:
            if eps is None:
                eps = torch.randn(z_mu.shape, generator=generator,
                                  device=z_mu.device)
            z = z_mu + eps * torch.exp(0.5 * z_logvar)
        else:
            z = z_mu
        x_dec = torch.zeros_like(x) if self.dx else x
        out = dict(z_mu=z_mu, z_logvar=z_logvar, z=z)
        if x_decode is not None:
            b = x.shape[0]
            feat, y_logvar, force_pred = self.decode_fn(torch.cat([z, z], 0),
                                                        torch.cat([x_dec, x_decode], 0))
            img = self.img_decode(feat)
            out.update(img_pred=img[:b], img_logvar=y_logvar[:b],
                       force_pred=force_pred[:b], force_logvar=y_logvar[:b],
                       img_pred_decode=img[b:], img_logvar_decode=y_logvar[b:],
                       force_pred_decode=force_pred[b:], force_logvar_decode=y_logvar[b:])
            return out
        feat, y_logvar, force_pred = self.decode_fn(z, x_dec)
        out.update(img_pred=self.img_decode(feat), img_logvar=y_logvar,
                   force_pred=force_pred, force_logvar=y_logvar)
        return out

    def decode_samples(self, state: ModelState, samples, use_z_ensemble: bool = False):
        """Batched decode of candidate poses with the current z seed, or,
        with ``use_z_ensemble``, under every latent of the ring in one batch
        of z_mem * N rows, averaged over the ring. Returns (y_logvar (N,
        y_logvar_dim), img_feat)."""
        x = samples - state.seed_x[None, :] if self.dx else samples
        n = x.shape[0]
        if not use_z_ensemble:
            feat, y_logvar, _ = self.decode_fn(state.z[None, :].expand(n, self.z_dim), x)
            return y_logvar, feat
        zs = state.z_buff[:, None, :].expand(self.z_mem, n, self.z_dim)
        xs = x[None].expand(self.z_mem, *x.shape)
        feat, y_logvar, _ = self.decode_fn(zs.reshape(-1, self.z_dim),
                                           xs.reshape(-1, x.shape[1]))
        return (y_logvar.reshape(self.z_mem, n, -1).mean(0),
                feat.reshape(self.z_mem, n, -1).mean(0))

    @torch.no_grad()
    def pdf(self, state: ModelState, samples, use_z_ensemble: bool = False):
        """Predictive-uncertainty target: exp(y_logvar) max over channels at
        each candidate pose (averaged over the z ring with
        ``use_z_ensemble``); uniform before the first sample."""
        y_logvar, _ = self.decode_samples(state, samples, use_z_ensemble)
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
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


@torch.no_grad()
def update_dist(model: CVAE, state: ModelState, x, y, force=None):
    """Re-seed the target distribution from the latest sample and shift its
    latent into the z ring. x (s_dim,), y (H, W, C), force (1,); with
    ``learn_force`` a missing force encodes as zero. Returns (state,
    forward outputs)."""
    force_b = None
    if model.learn_force:
        force_b = (force if force is not None else x.new_zeros(1))[None, :]
    out = model(x[None], y[None], force=force_b, train=False)
    z = out["z"][0]
    return ModelState(
        seed_x=x,
        seed_y=y.float(),  # the ring may hold bf16; the seed stays f32
        seed_force=force if force is not None else state.seed_force,
        z=z,
        z_buff=torch.cat([z[None], state.z_buff[:-1]], 0),
        initialized=torch.ones((), dtype=torch.bool, device=x.device),
    ), out

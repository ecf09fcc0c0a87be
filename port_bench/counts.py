"""The yardstick's arithmetic: the chip's published peaks, the model FLOPs
of a tick, and K1's least time, each a function of the configuration's
shapes (and, for K1, of the unmasked points these inputs have) only, so
it reads the same whichever conv path, decoder mode or kernel the program
runs.

Model FLOPs count two operations a multiply-add of the CVAE's convs, its
transposed convs (every input pixel scatters k * k * c_out products; the
zeros that output padding adds cost nothing) and its dense layers. A
training step is its forward pass and twice that for the backward. The
configuration's variants count as the CVAE runs them: ``learn_force``
widens the encoder's dense input by the force and the decoder's head by
its prediction; ``use_z_ensemble`` decodes each target sample under each
of the z ring's ``Z_MEM`` latents.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

Z_MEM = 5  # the z ring's latents (the CVAE's z_mem, the reference's build_z_buffer)


def conv_dims(hw, kernels, strides) -> list:
    """Spatial dims of a VALID conv stack, the input first."""
    dims = [tuple(hw)]
    for k, s in zip(kernels, strides):
        h, w = dims[-1]
        dims.append(((h - k) // s + 1, (w - k) // s + 1))
    return dims


def _mlp(widths) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def hidden_widths(cfg: dict) -> tuple:
    """The dense stack's widths after the reference's auto-expansion: a
    layer is put in front while the conv features outnumber the first
    width more than eightfold (``load_config.py:158-170``)."""
    h, w = conv_dims(cfg["image_dim"][:2], cfg["cnn_kernels"], cfg["cnn_strides"])[-1]
    feat = h * w * cfg["cnn_channels"][-1]
    hidden = list(cfg["hidden_dim"])
    while feat / hidden[0] > 8:
        scale = int(min(math.ceil(math.sqrt(feat / hidden[0])), 8))
        hidden = [hidden[0] * scale] + hidden
    return tuple(hidden)


def cvae_flops(cfg: dict) -> dict:
    """FLOPs per row of the CVAE's parts: ``encode`` (convs and dense
    stack), ``decode_mlp`` (the dense decoder, all the planner's pdf
    decodes) and ``img_decode`` (the transposed convs)."""
    ks, ss, cs = cfg["cnn_kernels"], cfg["cnn_strides"], cfg["cnn_channels"]
    dims = conv_dims(cfg["image_dim"][:2], ks, ss)
    cin = [cfg["image_dim"][2]] + list(cs[:-1])
    conv = sum(2 * dims[i + 1][0] * dims[i + 1][1] * cin[i] * cs[i] * ks[i] ** 2
               for i in range(len(ks)))
    # the transposed convs run the forward convs backwards: input dims[i+1]
    deconv = sum(2 * dims[i + 1][0] * dims[i + 1][1] * cs[i] * cin[i] * ks[i] ** 2
                 for i in range(len(ks)))
    h, w = dims[-1]
    feat = h * w * cs[-1]
    hidden, z, s = hidden_widths(cfg), cfg["z_dim"], len(cfg["states"])
    force = 1 if cfg["learn_force"] else 0
    return dict(encode=conv + _mlp([feat + force + s, *hidden, 2 * z]),
                decode_mlp=_mlp([z + s, *reversed(hidden), cfg["y_logvar_dim"] + force + feat]),
                img_decode=deconv)


def trainer_call_flops(cfg: dict) -> int:
    """One trainer call: ``num_learning_opt`` steps, each a forward pass of
    ``batch_size`` encodes and twice as many decodes (the sample's pose and
    the cross-decode's), and a backward of twice the forward."""
    f = cvae_flops(cfg)
    b = cfg["batch_size"]
    forward = b * f["encode"] + 2 * b * (f["decode_mlp"] + f["img_decode"])
    return cfg["num_learning_opt"] * 3 * forward


def tick_flops(cfg: dict, learning: bool, trained: bool) -> int:
    """One tick: the planner's target decode at ``num_target_samples``
    poses (under each of the ``Z_MEM`` latents with ``use_z_ensemble``);
    in the learning loop the new sample's encode and decode (its latent
    reseeds the target) and, on a throttled tick, one trainer call, with a
    fresh plain decode of the target samples for its entropy grade where
    the call does not take the planner's (``hyper_from_planner`` off, or
    the planner's decode an ensemble's)."""
    f = cvae_flops(cfg)
    samples = cfg["num_target_samples"]
    n = samples * (Z_MEM if cfg["use_z_ensemble"] else 1) * f["decode_mlp"]
    if learning:
        n += f["encode"] + f["decode_mlp"] + f["img_decode"]
    if trained:
        n += trainer_call_flops(cfg)
        if cfg["use_z_ensemble"] or not cfg["hyper_from_planner"]:
            n += samples * f["decode_mlp"]
    return n


def k1_bound_s(n: int, t: int, d: int, unmasked: int) -> tuple:
    """The least time of one K1 launch over ``n`` samples and ``t``
    trajectory points of which ``unmasked`` count: 3d + 5 f32 operations
    for each pair of a sample and an unmasked point (d subtractions and
    FMAs, the scale, the exponential, the mask, the add and the max) at the
    f32 peak, against each input read once and both outputs written once
    at the HBM rate. Returns (seconds, what bounds it)."""
    ops_s = n * unmasked * (3 * d + 5) / PEAK_F32_FLOPS
    bytes_s = 4 * (n * d + t * d + d + t + 2 * n) / PEAK_HBM_BYTES
    return max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def k1_tick_launches(cfg: dict, learning: bool, fill: int) -> list:
    """(n, t, d, unmasked) of each K1 launch of one planner call whose
    history holds ``fill`` points: the coverage spread over the whole
    history (learning loop only), the base footprint of the
    ``num_traj_samples`` history draw (its first ``fill`` valid), the
    initial cost, and the footprint and the cost of each inner
    iteration, each over the ``horizon`` points of a plan."""
    n, d, h = cfg["num_target_samples"], len(cfg["states"]), cfg["horizon"]
    cap, draw = cfg["traj_buffer_capacity"], cfg["num_traj_samples"]
    iters = max(1, int(0.5 * h))
    out = [(n, cap, d, min(fill, cap))] if learning else []
    out.append((n, draw, d, min(fill, draw)))
    out += [(n, h, d, h)] * (1 + 2 * iters)
    return out

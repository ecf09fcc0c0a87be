"""JAX CVAE parameters and Adam state -> the port's ``state_dict``s.

``params_from_jax`` inverts ``ealv_tpu/utils/torch_import.py::
convert_state_dict``, so both packages compute the same function from the
same weights:

  - flax Dense kernel (in, out)       -> Linear weight (out, in)
  - flax Conv kernel (kH, kW, I, O)   -> Conv2d weight (O, I, kH, kW)
  - flax ConvTranspose kernel (kH, kW, I, O) -> ConvTranspose2d weight
    (I, O, kH, kW) with both spatial axes flipped (the JAX decoder's
    (k-1, k-1+deficit) padding is the port's output_padding)
  - the conv features flatten (h, w, C) in JAX and (C, h, w) here, so the
    feature columns of ``enc_fc0`` and the feature rows of ``dec_out`` are
    permuted. The force variant's extra encoder input column (after the
    features) and decoder output row (after the logvars) stay in place.

``opt_state_from_jax`` carries an optax ``ScaleByAdamState`` or the JAX
package's ``PallasAdamState`` (count, mu, nu) over to the port's
optimizer: the moments are parameter-shaped trees, so they go through the
same mapping as the parameters.

``arm_state_from_jax`` carries a JAX ``ArmState`` over to the port's, so
both simulators can continue from the same joints and scene.

Values may be JAX arrays or numpy arrays; only numpy is used here.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.adam import FusedAdam


def _feat_perm(inner_hw, channels):
    """perm[jax_flat_idx] = torch_flat_idx for the conv-feature vector."""
    h, w = inner_hw
    return np.arange(channels * h * w).reshape(channels, h, w).transpose(1, 2, 0).ravel()


def params_from_jax(params, model) -> dict:
    """Flax CVAE variables (``{"params": {...}}`` or the inner dict) ->
    ``state_dict`` of ``model`` (a ``ealv_tpu_torch.models.CVAE`` of the
    same architecture). Shapes are checked against the model."""
    p = params.get("params", params)
    a = lambda v: np.asarray(v, dtype=np.float32)
    c_last, h, w = model.inner_shape
    perm = _feat_perm((h, w), c_last)
    v = model.y_logvar_dim
    nf = model.force_dim
    sd = {}

    convs = [i for i, m in enumerate(model.img_encoder) if isinstance(m, nn.Conv2d)]
    for j, li in enumerate(convs):
        sd[f"img_encoder.{li}.weight"] = a(p[f"enc_conv{j}"]["kernel"]).transpose(3, 2, 0, 1)
        sd[f"img_encoder.{li}.bias"] = a(p[f"enc_conv{j}"]["bias"])

    fcs = [i for i, m in enumerate(model.encode) if isinstance(m, nn.Linear)]
    for j, li in enumerate(fcs):
        name = f"enc_fc{j}" if j < len(fcs) - 1 else "enc_out"
        W = a(p[name]["kernel"]).T  # (out, in), columns in JAX order
        if j == 0:
            col_perm = np.concatenate([perm, model.feat_dim + np.arange(nf + model.s_dim)])
            Wt = np.empty_like(W)
            Wt[:, col_perm] = W
            W = Wt
        sd[f"encode.{li}.weight"] = W
        sd[f"encode.{li}.bias"] = a(p[name]["bias"])

    fcs = [i for i, m in enumerate(model.decode) if isinstance(m, nn.Linear)]
    for j, li in enumerate(fcs):
        name = f"dec_fc{j}" if j < len(fcs) - 1 else "dec_out"
        W, b = a(p[name]["kernel"]).T, a(p[name]["bias"])
        if j == len(fcs) - 1:
            row_perm = np.concatenate([np.arange(v + nf), v + nf + perm])
            Wt, bt = np.empty_like(W), np.empty_like(b)
            Wt[row_perm], bt[row_perm] = W, b
            W, b = Wt, bt
        sd[f"decode.{li}.weight"] = W
        sd[f"decode.{li}.bias"] = b

    tconvs = [i for i, m in enumerate(model.img_decoder)
              if isinstance(m, nn.ConvTranspose2d)]
    for j, li in enumerate(tconvs):
        K = a(p[f"dec_conv{j}"]["kernel"])
        sd[f"img_decoder.{li}.weight"] = K[::-1, ::-1].transpose(2, 3, 0, 1)
        sd[f"img_decoder.{li}.bias"] = a(p[f"dec_conv{j}"]["bias"])

    ref = model.state_dict()
    if set(ref) != set(sd):
        raise ValueError(f"parameter keys differ: {sorted(set(ref) ^ set(sd))}")
    for k, t in ref.items():
        if tuple(t.shape) != sd[k].shape:
            raise ValueError(f"shape mismatch at {k}: JAX gives {sd[k].shape}, "
                             f"model expects {tuple(t.shape)}")
    return {k: torch.from_numpy(np.array(x)) for k, x in sd.items()}


def _find_adam_state(state):
    """The (count, mu, nu) node of an optax state tree."""
    if all(hasattr(state, k) for k in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, model, opt) -> dict:
    """JAX Adam state -> ``state_dict`` for ``opt``, a
    ``torch.optim.Adam`` or a ``FusedAdam`` over ``model.parameters()``."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the JAX optimizer state")
    count = int(np.asarray(adam.count))
    mu, nu = params_from_jax(adam.mu, model), params_from_jax(adam.nu, model)
    names = [n for n, _ in model.named_parameters()]
    sd = opt.state_dict()
    state = {}
    for i, name in enumerate(names):
        state[i] = {"exp_avg": mu[name], "exp_avg_sq": nu[name]}
        if not isinstance(opt, FusedAdam):
            state[i]["step"] = torch.tensor(float(count))
    groups = [dict(g, step=count) if isinstance(opt, FusedAdam) else g
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def arm_state_from_jax(state, device="cuda"):
    """A JAX ``ArmState`` (its arrays as JAX or numpy arrays) -> the port's
    ``ArmState`` on ``device``: the same joints, pose, twist, brightness,
    command count and scene, so both simulators continue from one state."""
    from ..sim.arm import ArmState
    from ..sim.renderer import TrayScene

    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    sc = state.scene
    scene = TrayScene(obj_xy=t(sc.obj_xy), obj_radius=t(sc.obj_radius),
                      obj_height=t(sc.obj_height), obj_color=t(sc.obj_color),
                      ground_color=t(sc.ground_color), checker_scale=float(sc.checker_scale))
    return ArmState(q=t(state.q), qdot=t(state.qdot), pose=t(state.pose), vel=t(state.vel),
                    brightness=t(state.brightness), count=int(np.asarray(state.count)),
                    scene=scene)

"""JAX CVAE parameters and Adam state -> the port's ``state_dict``s.

``params_from_jax`` inverts ``ealv_tpu/utils/torch_import.py::
convert_state_dict``, so both packages compute the same function from the
same weights:

  - flax Dense kernel (in, out)       -> Linear weight (out, in)
  - flax Conv kernel (kH, kW, I, O)   -> Conv2d weight (O, I, kH, kW)
  - flax ConvTranspose kernel (kH, kW, I, O) -> ConvTranspose2d weight
    (I, O, kH, kW) with both spatial axes flipped (the JAX decoder's
    (k-1, k-1+deficit) padding is the port's output_padding; the
    ``"subpixel"`` decoder's layers are the same), and the
    ``"resize_conv"`` decoder's flax Conv kernels like the encoder's
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
``experiment_state_from_jax`` carries a whole JAX ``ExperimentState`` over
(weights, Adam moments, rings, planner, z ring, env, schedules), so the
port's tick can start from any state a JAX run visits;
``planner_state_from_jax`` and ``env_state_from_jax`` carry its planner
and env alone (as an evaluation runtime's state holds them).

Values may be JAX arrays or numpy arrays; only numpy is used here.
"""

from __future__ import annotations

import dataclasses

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

    dconvs = [(i, m) for i, m in enumerate(model.img_decoder)
              if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    for j, (li, m) in enumerate(dconvs):
        K = a(p[f"dec_conv{j}"]["kernel"])
        sd[f"img_decoder.{li}.weight"] = (K[::-1, ::-1].transpose(2, 3, 0, 1)
                                          if isinstance(m, nn.ConvTranspose2d)
                                          else K.transpose(3, 2, 0, 1))
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

    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    scene = scene_from_jax(state.scene, device)
    return ArmState(q=t(state.q), qdot=t(state.qdot), pose=t(state.pose), vel=t(state.vel),
                    brightness=t(state.brightness), count=int(np.asarray(state.count)),
                    scene=scene)


def scene_from_jax(sc, device="cuda"):
    """A JAX ``TrayScene`` -> the port's on ``device``."""
    from ..sim.renderer import TrayScene

    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    return TrayScene(obj_xy=t(sc.obj_xy), obj_radius=t(sc.obj_radius),
                     obj_height=t(sc.obj_height), obj_color=t(sc.obj_color),
                     ground_color=t(sc.ground_color), checker_scale=float(sc.checker_scale))


def _memory_from_jax(mem, device):
    from ..data.replay import TrajMemory

    i = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int64, device=device)
    return TrajMemory(buf=torch.tensor(np.asarray(mem.buf, np.float32), device=device),
                      pos=i(mem.pos), size=i(mem.size))


def env_state_from_jax(env, device="cuda"):
    """A JAX env state, the free env's ``EnvState`` or an ``ArmState``,
    -> the port's on ``device``."""
    from ..sim.env import EnvState

    if hasattr(env, "q"):
        return arm_state_from_jax(env, device)
    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    return EnvState(pose=t(env.pose), vel=t(env.vel), brightness=t(env.brightness),
                    scene=scene_from_jax(env.scene, device))


def planner_state_from_jax(ps, like):
    """A JAX ``PlannerState`` (or baseline ``BaselineState``) -> the port's,
    with the random stream of ``like``, a port state of the same planner."""
    from ..control.barrier import BarrierFunction
    from ..control.dynamics import DynState

    dev = like.memory.buf.device
    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=dev)
    memory = _memory_from_jax(ps.memory, dev)
    if not hasattr(ps, "u"):
        return dataclasses.replace(like, x=t(ps.x), last_vel=t(ps.last_vel), memory=memory)
    b = ps.barrier
    return dataclasses.replace(
        like, u=t(ps.u), dyn=DynState(x=t(ps.dyn.x), R=t(ps.dyn.R)), memory=memory,
        lims=t(ps.lims), last_plan=t(ps.last_plan),
        barrier=BarrierFunction(b_lim=t(b.b_lim), barr_weight=t(b.barr_weight),
                                power=t(b.power)))


def experiment_state_from_jax(es, exp, seed: int = 0):
    """A JAX ``ExperimentState`` (its leaves as JAX or numpy arrays) -> the
    port's ``ExperimentState`` for ``exp``, a port ``Experiment`` of the
    same configuration: the weights and Adam moments, the replay ring with
    its head, fill and push counts and the hyperparameter ring, the
    planner's (or baseline's) state with its trajectory ring, the target
    distribution's state and z ring, the env (free or arm), beta, gamma,
    the optimizer iterations and the step counters. The optimizer, the
    barrier's structure and the random streams come from ``exp.init(seed)``:
    a JAX key has no port counterpart, so draws that must match are fed."""
    from ..models.cvae import ModelState
    from ..runtime.schedules import HyperState

    dev = exp.device
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=dev)
    i64 = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int64, device=dev)
    out = exp.init(seed)
    out.model.load_state_dict(params_from_jax(es.params, out.model))
    out.opt.load_state_dict(opt_state_from_jax(es.opt_state, out.model, out.opt))

    ms = es.mstate
    out.mstate = ModelState(seed_x=f32(ms.seed_x), seed_y=f32(ms.seed_y),
                            seed_force=f32(ms.seed_force), z=f32(ms.z),
                            z_buff=f32(ms.z_buff),
                            initialized=torch.tensor(bool(np.asarray(ms.initialized)),
                                                     device=dev))

    b, buf = es.buf, out.buf
    buf.x, buf.force, buf.y_var = f32(b.x), f32(b.force), f32(b.y_var)
    buf.y = torch.tensor(np.asarray(b.y, np.float32), device=dev).to(buf.y.dtype)
    buf.beta, buf.gamma = f32(b.beta), f32(b.gamma)
    buf.beta_pos, buf.beta_size, buf.explr_ind = i64(b.beta_pos), i64(b.beta_size), \
        i64(b.explr_ind)
    buf.pos, buf.size, buf.total = i64(b.pos), i64(b.size), i64(b.total)

    out.pstate = planner_state_from_jax(es.pstate, out.pstate)
    out.env = env_state_from_jax(es.env, dev)
    out.hyper = HyperState(beta=f32(es.hyper.beta), gamma=f32(es.hyper.gamma),
                           iter=int(np.asarray(es.hyper.iter)))
    out.explr_step = int(np.asarray(es.explr_step))
    out.learning_ind = int(np.asarray(es.learning_ind))
    return out

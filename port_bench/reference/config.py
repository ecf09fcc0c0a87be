"""Experiment configuration: a frozen copy of the port's
``ealv_tpu_torch/utils/config.py`` (fields, defaults, the limit tables and
the derived values), which the reference reads the cells' configurations
into.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np

RAW_STATES = "xyzrpwb"

# test_config.yaml:34-68 (tray workspace of the hardware rig)
TRAY_LIM = {
    "x": (0.325, 0.625), "y": (-0.15, 0.15), "z": (0.2, 0.5),
    "r": (2.39, 3.89), "p": (-0.75, 0.75), "w": (-2.0, 2.0), "b": (0.0, 1.0),
}
TRAY_CTRL_LIM = {
    "x": (-0.1, 0.1), "y": (-0.1, 0.1), "z": (-0.1, 0.1),
    "r": (-0.25, 0.25), "p": (-0.25, 0.25), "w": (-1.0, 1.0), "b": (-1.0, 1.0),
}
ROBOT_LIM = {
    "x": (-1.0, 1.0), "y": (-1.0, 1.0), "z": (-1.0, 1.0),
    "r": (-0.75, 0.75), "p": (-0.75, 0.75), "w": (-1.0, 1.0), "b": (-1.0, 1.0),
}
ROBOT_CTRL_LIM = {
    "x": (-1.25, 1.25), "y": (-1.25, 1.25), "z": (-1.25, 1.25),
    "r": (-0.5, 0.5), "p": (-0.5, 0.5), "w": (-1.25, 1.25), "b": (-1.5, 1.5),
}


def kernel_std(robot_lim: np.ndarray, num_target_samples: int) -> float:
    """Ergodic kernel width from the n-ball volume heuristic
    (load_config.py:130-138): the std whose n-ball occupies
    0.1/num_target_samples of the workspace volume."""
    n = robot_lim.shape[0]
    vol = float(np.prod(robot_lim[:, 1] - robot_lim[:, 0]))
    ratio = 0.1 / num_target_samples
    return float((ratio * vol * math.gamma(n / 2 + 1) / math.pi ** (n / 2)) ** (1 / n))


def expand_hidden(hidden: Sequence[int], input_dim_prod: int) -> Tuple[int, ...]:
    """Auto-add FC layers when the conv feature dim is much larger than the
    first hidden layer (load_config.py:158-170)."""
    hidden = list(hidden)
    max_scale = 8
    while input_dim_prod / hidden[0] > max_scale:
        scale = int(min(math.ceil(math.sqrt(input_dim_prod / hidden[0])), max_scale))
        hidden = [hidden[0] * scale] + hidden
    return tuple(hidden)


def conv_output_dims(hw, kernels, strides):
    """Spatial dims after a VALID conv stack. Returns (final_hw,
    per_layer_dims) where per_layer_dims[0] is the input."""
    dims = [tuple(hw)]
    for k, s in zip(kernels, strides):
        h, w = dims[-1]
        dims.append(((h - k) // s + 1, (w - k) // s + 1))
    return dims[-1], dims


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # exploration (test_env_vars.sh:23, test_config.yaml:2-20)
    states: str = "xyw"
    explr_method: str = "entklerg"  # entklerg | unifklerg | uniform | randomWalk
    num_steps: int = 1000
    horizon: int = 10
    num_target_samples: int = 2000
    num_traj_samples: int = 3000
    traj_buffer_capacity: int = 3000
    buffer_capacity: int = 3000
    R: float = 0.5
    dt: float = 0.2
    data_to_ctrl_rate: int = 1
    use_vel: bool = True
    use_magnitude: bool = False
    explr_robot_lim_scale: float = 1.0
    # simulator backend: 'free' = clipped free-flying pose integrator,
    # 'arm' = joint-space 7-DOF kinematic arm (Jacobian-pinv vel control,
    # DLS IK pose control, drift correction — sim/arm.py),
    # 'arm-dynamic' = same arm with penalty contact mechanics: 3-vector
    # contact force from cylinder penetration (franka_env.py:268-284
    # parity) and optional object displacement (obj_mobility > 0),
    # 'arm-dynamic-soft' = soft (compliant, saturating-force, never
    # motion-blocking) objects — the loadSoftBody variant
    # (franka_env.py:160-162)
    sim_backend: str = "free"
    obj_mobility: float = 0.0  # m displaced per m of side penetration
    # model (test_config.yaml:69-82)
    image_dim: Tuple[int, int, int] = (180, 180, 3)  # post-downsample H, W, C
    z_dim: int = 16
    y_logvar_dim: int = 1
    hidden_dim: Tuple[int, ...] = (512, 256)
    cnn_kernels: Tuple[int, ...] = (3, 3, 5)
    cnn_strides: Tuple[int, ...] = (2, 2, 3)
    cnn_channels: Tuple[int, ...] = (10, 10, 20)
    learn_force: bool = False
    dx: bool = False
    prior_steps: int = 0  # use the scene prior for the first N steps (test_config.yaml:81)
    use_z_ensemble: bool = False  # z-ensemble uncertainty (build_z_buffer)
    intensity: bool = False  # grayscale images (load_config.py intensity flag)
    # activation compute dtype: bf16 keeps params/losses f32 but runs the
    # conv/dense stacks in bf16
    compute_dtype: str = "bfloat16"
    # image decoder family (models/cvae.py): 'conv_transpose' (the
    # reference's stack), 'subpixel' (its layers by phase decomposition,
    # short layers edge-padded) or 'resize_conv' (nearest resize + SAME conv)
    decoder_mode: str = "conv_transpose"
    # encoder weight-gradient schedule (ops/fast_conv.py): False =
    # autograd's conv wgrad, True/'s2d' = space-to-depth, 'im2col' = the
    # patch-matrix product, 'pallas' = the direct wgrad kernel K3
    fast_encoder_grads: object = False
    # compute the encoder convs (unless fast_encoder_grads) and the
    # 'conv_transpose' layers on channels zero-padded to a multiple of
    # this; 0 = the native channel counts. Parameters do not change
    lane_pad: int = 0
    # trainer (test_config.yaml:83-104)
    model_lr: float = 1e-3
    batch_size: int = 64
    num_learning_opt: int = 25
    target_learning_rate: float = 3.0
    frames_before_training: int = 1
    gamma_weight: float = 0.1
    other_locs: bool = True
    fixed_beta: bool = False
    beta_manual_ramp: bool = False
    fixed_gamma: bool = False
    gamma_manual_ramp: bool = False
    beta_start_weight: float = 0.0
    beta_end_weight: float = 0.05
    beta_warmup_steps: int = 1000
    beta_warmup_epoch: int = 10
    gamma_start_weight: float = 0.0
    gamma_end_weight: float = 1.0
    gamma_warmup_steps: int = 1000
    gamma_warmup_epoch: int = 10
    xi: float = 4.0  # entropy exponent (trainer_module.py:537-538)
    # reuse the planner's same-tick pdf decode + coverage spread for the
    # entropy beta/gamma schedule instead of a second 2000-sample decode
    # (inputs differ by one observation; loss-trajectory equivalence is
    # tested). False = the reference's literal pre_train_mp recompute.
    hyper_from_planner: bool = True
    seed: int = 0

    # ---- derived ----
    def sel(self):
        """Indices of self.states within the raw pose order 'xyzrpwb'."""
        return [RAW_STATES.rfind(s) for s in self.states]

    def lims(self, table):
        return np.asarray([table[s] for s in self.states], np.float32)

    @property
    def tray_lim(self):
        return self.lims(TRAY_LIM)

    @property
    def tray_ctrl_lim(self):
        return self.lims(TRAY_CTRL_LIM)

    @property
    def robot_lim(self):
        return self.lims(ROBOT_LIM)

    @property
    def robot_ctrl_lim(self):
        return self.lims(ROBOT_CTRL_LIM)

    @property
    def std(self) -> float:
        return kernel_std(self.robot_lim, self.num_target_samples)

    @property
    def s_dim(self) -> int:
        return len(self.states)

    def model_hidden(self) -> Tuple[int, ...]:
        (h, w), _ = conv_output_dims(self.image_dim[:2], self.cnn_kernels, self.cnn_strides)
        return expand_hidden(self.hidden_dim, h * w * self.cnn_channels[-1])

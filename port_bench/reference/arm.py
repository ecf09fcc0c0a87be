"""The 7-DoF arm of the ``arm-dynamic`` backend, in plain torch: Panda
modified-DH kinematics, the geometric Jacobian, the damped least-squares
joint step, the fixed-trip IK, penalty contact with the tray's cylinders
and the table, the contact guard, velocity control over ``substeps``
integration steps and the drift correction every ``drift_every``
commands (a 5-iteration IK that re-levels roll and pitch).

It follows the port's ``ealv_tpu_torch/sim/arm.py`` operation for
operation, so that on one device the two give the same bits, and imports
nothing of the program. Rigid objects only (``arm-dynamic``; the soft
variant and the backend without contact are not covered).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .renderer import TrayScene, render_camera
from .rotations import euler_angles_to_matrix, matrix_to_euler_angles

# Panda modified-DH rows (a_{i-1}, d_i, alpha_{i-1}) and the flange offset
DH_A = np.array([0.0, 0.0, 0.0, 0.0825, -0.0825, 0.0, 0.088], np.float32)
DH_D = np.array([0.333, 0.0, 0.316, 0.0, 0.384, 0.0, 0.0], np.float32)
DH_ALPHA = np.array([0.0, -np.pi / 2, np.pi / 2, np.pi / 2, -np.pi / 2, np.pi / 2,
                     np.pi / 2], np.float32)
FLANGE_D = 0.107
Q_MIN = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973],
                 np.float32)
Q_MAX = np.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973], np.float32)
QD_MAX = np.array([2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61], np.float32)
Q_HOME = np.array([0.0, -0.3135, 0.0, -2.0, 0.0, 1.8675, 0.0], np.float32)
DRIFT_EVERY = 20  # velocity commands between two drift corrections
DRIFT_IK_ITERS = 5


def _t(v, device):
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _chain(q):
    """Prefix transforms of the DH chain: (7, 4, 4), frame i after joint i."""
    dev = q.device
    ca, sa = np.cos(DH_ALPHA), np.sin(DH_ALPHA)
    ct, st = torch.cos(q), torch.sin(q)
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    links = torch.stack([
        ct, -st, zero, _t(DH_A, dev),
        st * _t(ca, dev), ct * _t(ca, dev), _t(-sa, dev), _t(-DH_D * sa, dev),
        st * _t(sa, dev), ct * _t(sa, dev), _t(ca, dev), _t(DH_D * ca, dev),
        zero, zero, zero, one], -1).reshape(7, 4, 4)
    frames = [links[0]]
    for i in range(1, 7):
        frames.append(frames[-1] @ links[i])
    return torch.stack(frames)


def _ee(frames):
    T = frames[-1]
    return T[:3, 3] + FLANGE_D * T[:3, 2], T[:3, :3]


def fk(q):
    """q (7,) -> (end-effector position (3,), rotation (3, 3))."""
    return _ee(_chain(q))


def _jacobian(frames):
    p_ee, _ = _ee(frames)
    z, p = frames[:, :3, 2], frames[:, :3, 3]
    return torch.cat([torch.linalg.cross(z, p_ee - p), z], 1).T


def geometric_jacobian(q):
    """The 6x7 geometric Jacobian [J_v; J_w] at the end effector."""
    return _jacobian(_chain(q))


def dls_step(J, twist, damping=1e-2):
    """J^T (J J^T + damping^2 I)^-1 twist, by Cholesky and two triangular
    solves."""
    A = J @ J.T + damping ** 2 * torch.eye(6, device=J.device)
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, twist[:, None], upper=False)
    return J.T @ torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


def ik_step(q, target_p, target_R, gain=0.8, damping=5e-2):
    frames = _chain(q)
    p, R = _ee(frames)
    R_err = target_R @ R.T
    w = 0.5 * torch.stack([R_err[2, 1] - R_err[1, 2], R_err[0, 2] - R_err[2, 0],
                           R_err[1, 0] - R_err[0, 1]])
    twist = torch.cat([target_p - p, w])
    return torch.clamp(q + gain * dls_step(_jacobian(frames), twist, damping),
                       _t(Q_MIN, q.device), _t(Q_MAX, q.device))


def solve_ik(q0, pose6, iters: int = 50):
    """Fixed-trip DLS IK toward ``pose6`` (x, y, z and XYZ Euler angles)."""
    target_R = euler_angles_to_matrix(pose6[3:], "XYZ")
    q = q0
    for _ in range(iters):
        q = ik_step(q, pose6[:3], target_R)
    return q


@dataclasses.dataclass
class ArmState:
    q: torch.Tensor
    qdot: torch.Tensor
    pose: torch.Tensor  # (6,) tray coords, xyzrpw
    vel: torch.Tensor
    brightness: torch.Tensor
    count: int  # velocity commands so far
    scene: TrayScene


@dataclasses.dataclass(frozen=True)
class ArmEnv:
    """Velocity control of the arm with rigid penalty contact."""

    tray_lim: tuple
    dt: float = 0.04
    img_hw: tuple = (180, 180)
    max_force: float = 30.0
    substeps: int = 4
    drift_every: int = DRIFT_EVERY
    contact_stiffness: float = 500.0
    obj_mobility: float = 0.0
    device: str = "cuda"

    def _lims(self):
        return torch.tensor(self.tray_lim, dtype=torch.float32, device=self.device)

    def ee_pose(self, q):
        """The end effector's tray pose, its Euler angles re-wrapped to the
        2 pi-equivalent nearest the tray box's centre."""
        p, R = fk(q)
        lims = self._lims()[3:]
        mid = 0.5 * (lims[:, 0] + lims[:, 1])
        rpw = matrix_to_euler_angles(R, "XYZ")
        rpw = rpw + 2 * math.pi * torch.round((mid - rpw) / (2 * math.pi))
        return torch.cat([p, rpw])

    def init(self, pose0, scene: TrayScene | None = None, ik_iters: int = 100) -> ArmState:
        q = solve_ik(_t(Q_HOME, self.device), pose0, iters=ik_iters)
        return ArmState(q=q, qdot=torch.zeros(7, device=self.device), pose=self.ee_pose(q),
                        vel=torch.zeros(6, device=self.device),
                        brightness=torch.tensor(1.0, device=self.device), count=0,
                        scene=scene if scene is not None else TrayScene.default(self.device))

    def contact(self, pose, scene: TrayScene):
        """(force (3,), push_xy (K, 2)): a penetration into a cylinder
        resolves along its shallower exit, side or top, with force
        stiffness x depth; the table pushes up; the force is clipped to
        ``max_force`` in norm."""
        dxy = pose[None, :2] - scene.obj_xy
        dist = torch.linalg.vector_norm(dxy, dim=1)
        n_xy = dxy / dist.clamp(min=1e-6)[:, None]
        pen_side = scene.obj_radius - dist
        pen_top = scene.obj_height - pose[2]
        inside = (pen_side > 0) & (pen_top > 0)
        side = inside & (pen_side < pen_top)
        f_side = torch.where(side[:, None], (self.contact_stiffness * pen_side)[:, None] * n_xy,
                             0.0)
        f_top = torch.where(inside & ~side, self.contact_stiffness * pen_top, 0.0)
        table_z = self.tray_lim[2][0] - 0.01
        force = torch.cat([f_side.sum(0), (f_top.sum()
                                           + self.contact_stiffness
                                           * (table_z - pose[2]).clamp(min=0.0))[None]])
        push_xy = torch.where(side[:, None], -self.obj_mobility * pen_side[:, None] * n_xy,
                              0.0)
        norm = torch.linalg.vector_norm(force)
        scale = torch.where(norm > self.max_force, self.max_force / norm.clamp(min=1e-9), 1.0)
        return force * scale, push_xy

    def guard(self, s: ArmState, cmd):
        """Deep rigid contact removes the commanded motion into the contact
        normal."""
        f3, _ = self.contact(s.pose, s.scene)
        fn = torch.linalg.vector_norm(f3)
        n = f3 / fn.clamp(min=1e-9)
        into = (cmd[:3] @ -n).clamp(min=0.0)
        lin = torch.where(fn > 0.75 * self.max_force, cmd[:3] + into * n, cmd[:3])
        return torch.cat([lin, cmd[3:]])

    def step_vel(self, s: ArmState, cmd_vel, cmd_brightness=None) -> ArmState:
        """A twist through the contact guard, as damped pseudo-inverse joint
        velocities over ``substeps`` steps; at every ``drift_every``-th
        command the drift correction toward the reached pose with roll and
        pitch levelled."""
        dev = s.q.device
        cmd = self.guard(s, torch.as_tensor(cmd_vel, dtype=torch.float32, device=dev))
        dt_sub = self.dt / self.substeps
        q_min, q_max, qd_max = _t(Q_MIN, dev), _t(Q_MAX, dev), _t(QD_MAX, dev)
        q, qd = s.q, None
        for _ in range(self.substeps):
            qd = torch.clamp(dls_step(geometric_jacobian(q), cmd), -qd_max, qd_max)
            q = torch.clamp(q + qd * dt_sub, q_min, q_max)
        count = s.count + 1
        pose = self.ee_pose(q)
        if self.drift_every > 0 and count % self.drift_every == 0:
            fix = torch.cat([pose[:3], _t([math.pi, 0.0], dev), pose[5:]])
            q = solve_ik(q, fix, iters=DRIFT_IK_ITERS)
            pose = self.ee_pose(q)
        b = s.brightness if cmd_brightness is None else torch.as_tensor(
            cmd_brightness, dtype=torch.float32, device=dev)
        d = pose - s.pose
        dang = torch.remainder(d[3:] + math.pi, 2 * math.pi) - math.pi
        scene = s.scene
        if self.obj_mobility != 0.0:
            scene = scene._replace(obj_xy=scene.obj_xy + self.contact(pose, scene)[1])
        return ArmState(q=q, qdot=qd, pose=pose, vel=torch.cat([d[:3], dang]) / self.dt,
                        brightness=b, count=count, scene=scene)

    def observe(self, s: ArmState):
        """(pose, vel, contact force (3,), camera image (H, W, 3))."""
        img = render_camera(s.scene, s.pose, s.brightness, self.img_hw)
        return s.pose, s.vel, self.contact(s.pose, s.scene)[0], img

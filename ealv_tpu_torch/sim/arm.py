"""Joint-space 7-DOF arm simulator (port of ``ealv_tpu/sim/arm.py``).

Same ``init / step_vel / step_pose / observe`` surface as ``SyntheticEnv``,
backed by Franka Panda kinematics (modified-DH, public spec): end-effector
twists map to joint velocities through a damped pseudo-inverse of the
geometric Jacobian over ``substeps`` integration steps, pose commands go
through damped-least-squares IK and a rate-limited joint servo, and every
``drift_every`` velocity commands an IK step pins z and re-levels roll and
pitch. Unlike the free-flying env it shows the failures the host loop's
robustness layer handles: pseudo-inverse drift in uncontrolled axes,
joint-limit saturation near the workspace edge, yaw sticking and, with
``dynamic_contact``, the mechanical wedge against an object.

The kinematics are vectorised over the joints: the seven link transforms
are built as one (7, 4, 4) stack from the joints' cos/sin, and one pass
down the chain yields the end-effector pose and the Jacobian's columns.
The damped pseudo-inverse solves ``J J^T + lambda^2 I`` by Cholesky with
no error check, so nothing in ``step_vel``, ``step_pose`` or ``observe``
waits for the device. The drift-correction counter is a host int: the
correcting IK runs only on the steps that apply it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .renderer import TrayScene, render_camera
from ..utils.rotations import euler_angles_to_matrix, matrix_to_euler_angles

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


@dataclasses.dataclass(frozen=True)
class _Consts:
    """The kinematic constants as tensors on one device."""

    a: torch.Tensor
    ca: torch.Tensor
    sa: torch.Tensor
    neg_sa: torch.Tensor
    neg_dsa: torch.Tensor  # -d sin(alpha)
    dca: torch.Tensor  # d cos(alpha)
    q_min: torch.Tensor
    q_max: torch.Tensor
    qd_max: torch.Tensor
    q_home: torch.Tensor
    eye6: torch.Tensor
    level: torch.Tensor  # (roll, pitch) of a level, downward end effector


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> _Consts:
    t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    ca, sa = np.cos(DH_ALPHA), np.sin(DH_ALPHA)
    return _Consts(a=t(DH_A), ca=t(ca), sa=t(sa), neg_sa=t(-sa), neg_dsa=t(-DH_D * sa),
                   dca=t(DH_D * ca),
                   q_min=t(Q_MIN), q_max=t(Q_MAX), qd_max=t(QD_MAX), q_home=t(Q_HOME),
                   eye6=torch.eye(6, device=device), level=t([math.pi, 0.0]))


def home(device="cuda") -> torch.Tensor:
    """The home joint configuration (7,) on ``device``."""
    return _consts(torch.device(device)).q_home.clone()


def _chain(q):
    """Prefix transforms of the DH chain: (7, 4, 4), frame i after joint i."""
    c = _consts(q.device)
    ct, st = torch.cos(q), torch.sin(q)
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    links = torch.stack([
        ct, -st, zero, c.a,
        st * c.ca, ct * c.ca, c.neg_sa, c.neg_dsa,
        st * c.sa, ct * c.sa, c.ca, c.dca,
        zero, zero, zero, one], -1).reshape(7, 4, 4)
    frames = [links[0]]
    for i in range(1, 7):
        frames.append(frames[-1] @ links[i])
    return torch.stack(frames)


def _ee(frames):
    """End-effector position (3,) and rotation (3, 3) from the chain: the
    flange sits FLANGE_D along the last frame's z axis."""
    T = frames[-1]
    return T[:3, 3] + FLANGE_D * T[:3, 2], T[:3, :3]


def fk(q):
    """Forward kinematics: q (7,) -> (p_ee (3,), R_ee (3, 3))."""
    return _ee(_chain(q))


def _jacobian(frames):
    p_ee, _ = _ee(frames)
    z, p = frames[:, :3, 2], frames[:, :3, 3]
    return torch.cat([torch.linalg.cross(z, p_ee - p), z], 1).T


def geometric_jacobian(q):
    """6x7 geometric Jacobian [J_v; J_w] at the end effector."""
    return _jacobian(_chain(q))


def _dls_solve(J, twist, damping=1e-2):
    """Damped least-squares joint step J^T (J J^T + damping^2 I)^-1 twist:
    Cholesky of the symmetric positive definite 6x6 system with no error
    check (``torch.linalg.solve`` checks on the host), then two triangular
    solves."""
    A = J @ J.T + damping ** 2 * _consts(J.device).eye6
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, twist[:, None], upper=False)
    return J.T @ torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


def ik_step(q, target_p, target_R, gain=0.8, damping=5e-2):
    """One damped-least-squares IK iteration toward (target_p, target_R)."""
    frames = _chain(q)
    p, R = _ee(frames)
    R_err = target_R @ R.T
    w = 0.5 * torch.stack([R_err[2, 1] - R_err[1, 2], R_err[0, 2] - R_err[2, 0],
                           R_err[1, 0] - R_err[0, 1]])
    twist = torch.cat([target_p - p, w])
    c = _consts(q.device)
    return torch.clamp(q + gain * _dls_solve(_jacobian(frames), twist, damping),
                       c.q_min, c.q_max)


def solve_ik(q0, pose6, iters: int = 50):
    """Fixed-trip DLS IK toward ``pose6`` (x, y, z and XYZ Euler angles)."""
    target_R = euler_angles_to_matrix(pose6[3:], "XYZ")
    q = q0
    for _ in range(iters):
        q = ik_step(q, pose6[:3], target_R)
    return q


@dataclasses.dataclass
class ArmState:
    q: torch.Tensor  # (7,) joint positions
    qdot: torch.Tensor  # (7,) joint velocities (last commanded)
    pose: torch.Tensor  # (6,) end-effector pose (tray coords, xyzrpw)
    vel: torch.Tensor  # (6,) end-effector twist
    brightness: torch.Tensor  # ()
    count: int  # velocity commands so far (drift correction), a host int
    scene: TrayScene


@dataclasses.dataclass(frozen=True)
class ArmEnv:
    """``SyntheticEnv``'s surface over joint-space kinematics.

    ``tray_lim`` is the ((lo, hi) x 6) workspace box for clipping and the
    table; ``substeps`` integration steps per velocity command; drift
    correction every ``drift_every`` commands (0: never), pinning z with
    ``fix_z`` and re-levelling roll and pitch with ``level_ee``.

    ``dynamic_contact``: objects are vertical cylinders; a penetration
    resolves along its shallower exit (side or top) with force
    ``contact_stiffness`` x depth, deep contact blocks motion into it, and a
    side-pushed object moves by ``obj_mobility`` x depth (0 is a fixed
    base). ``soft_objects``: the objects yield instead, with force
    ``soft_compliance`` x the rigid stiffness at small depth, saturating
    with ``soft_sat_depth``, and never block motion.
    """

    tray_lim: tuple
    dt: float = 0.04
    img_hw: tuple = (180, 180)
    max_force: float = 30.0
    substeps: int = 4
    drift_every: int = 20
    fix_z: bool = False
    level_ee: bool = True
    dynamic_contact: bool = False
    contact_stiffness: float = 500.0
    obj_mobility: float = 0.0
    soft_objects: bool = False
    soft_compliance: float = 0.3
    soft_sat_depth: float = 0.05
    device: str = "cuda"

    @functools.cached_property
    def _lims(self):
        return torch.tensor(self.tray_lim, dtype=torch.float32, device=self.device)

    @functools.cached_property
    def _ang_mid(self):
        lims = self._lims[3:]
        return 0.5 * (lims[:, 0] + lims[:, 1])

    def _ee_pose(self, q):
        """Tray pose of the end effector: the Euler angles (in (-pi, pi])
        re-wrapped to the 2 pi-equivalent nearest the tray box's centre, so
        a roll near -pi lands in the roll box (2.39, 3.89)."""
        p, R = fk(q)
        rpw = matrix_to_euler_angles(R, "XYZ")
        rpw = rpw + 2 * math.pi * torch.round((self._ang_mid - rpw) / (2 * math.pi))
        return torch.cat([p, rpw])

    def init(self, pose0, scene: TrayScene | None = None, brightness=1.0,
             ik_iters: int = 100) -> ArmState:
        pose0 = torch.as_tensor(pose0, dtype=torch.float32, device=self.device)
        q = solve_ik(home(self.device), pose0, iters=ik_iters)
        return ArmState(q=q, qdot=torch.zeros(7, device=self.device), pose=self._ee_pose(q),
                        vel=torch.zeros(6, device=self.device),
                        brightness=torch.tensor(float(brightness), device=self.device),
                        count=0,
                        scene=scene if scene is not None else TrayScene.default(self.device))

    def reset_joints(self, s: ArmState) -> ArmState:
        """Joint reset to the home configuration."""
        q = home(self.device)
        return dataclasses.replace(s, q=q, qdot=torch.zeros(7, device=self.device),
                                   pose=self._ee_pose(q),
                                   vel=torch.zeros(6, device=self.device))

    def _pose_rate(self, pose, prev):
        """Finite-difference twist; the angle deltas wrapped to [-pi, pi),
        so an Euler jump at the wrist singularity is no huge rate."""
        d = pose - prev
        dang = torch.remainder(d[3:] + math.pi, 2 * math.pi) - math.pi
        return torch.cat([d[:3], dang]) / self.dt

    def _contact_force(self, pose, scene: TrayScene):
        """Object contact (pressing below an object's height) plus the
        table under the workspace, clipped at max_force."""
        d2 = ((pose[None, :2] - scene.obj_xy) ** 2).sum(1)
        top = (torch.exp(-0.5 * d2 / scene.obj_radius ** 2) * scene.obj_height).max()
        table_z = self.tray_lim[2][0] - 0.01
        pen = (top - pose[2]).clamp(min=0.0) + (table_z - pose[2]).clamp(min=0.0)
        return (pen * 500.0).clamp(0.0, self.max_force)

    def _pen_force(self, depth):
        """Object contact force for a penetration depth: stiffness x depth,
        or the soft objects' saturating k_soft x d / (1 + d / sat)."""
        if not self.soft_objects:
            return self.contact_stiffness * depth
        k_soft = self.contact_stiffness * self.soft_compliance
        return k_soft * depth / (1.0 + depth / self.soft_sat_depth)

    def _contact_wrench(self, pose, scene: TrayScene):
        """(force (3,) on the end effector, push_xy (K, 2)) from penalty
        contact with the cylinders and the table; the force is clipped to
        max_force in norm."""
        dxy = pose[None, :2] - scene.obj_xy
        dist = torch.linalg.vector_norm(dxy, dim=1)
        n_xy = dxy / dist.clamp(min=1e-6)[:, None]
        pen_side = scene.obj_radius - dist
        pen_top = scene.obj_height - pose[2]
        inside = (pen_side > 0) & (pen_top > 0)
        side = inside & (pen_side < pen_top)
        f_side = torch.where(side[:, None], self._pen_force(pen_side)[:, None] * n_xy, 0.0)
        f_top = torch.where(inside & ~side, self._pen_force(pen_top), 0.0)
        table_z = self.tray_lim[2][0] - 0.01
        force = torch.cat([f_side.sum(0), (f_top.sum()
                                           + self.contact_stiffness
                                           * (table_z - pose[2]).clamp(min=0.0))[None]])
        push_xy = torch.where(side[:, None], -self.obj_mobility * pen_side[:, None] * n_xy,
                              0.0)
        norm = torch.linalg.vector_norm(force)
        scale = torch.where(norm > self.max_force, self.max_force / norm.clamp(min=1e-9), 1.0)
        return force * scale, push_xy

    def _apply_contact(self, s: ArmState, pose) -> TrayScene:
        """Displace side-pushed objects (dynamic contact with mobility)."""
        if not self.dynamic_contact or self.obj_mobility == 0.0:
            return s.scene
        _, push_xy = self._contact_wrench(pose, s.scene)
        return s.scene._replace(obj_xy=s.scene.obj_xy + push_xy)

    def _guard(self, s: ArmState, cmd):
        """The commanded twist after the contact guard: with dynamic
        contact, deep rigid contact removes the motion into the contact
        normal; otherwise high force drops a downward z command."""
        if self.dynamic_contact:
            if self.soft_objects:  # the deformable yields: nothing blocks
                return cmd
            f3, _ = self._contact_wrench(s.pose, s.scene)
            fn = torch.linalg.vector_norm(f3)
            n = f3 / fn.clamp(min=1e-9)  # the force pushes the end effector out
            into = (cmd[:3] @ -n).clamp(min=0.0)
            lin = torch.where(fn > 0.75 * self.max_force, cmd[:3] + into * n, cmd[:3])
            return torch.cat([lin, cmd[3:]])
        blocked = (self._contact_force(s.pose, s.scene) > 0.75 * self.max_force) & (cmd[2] < 0)
        return torch.cat([cmd[:2], torch.where(blocked, 0.0, cmd[2])[None], cmd[3:]])

    def step_vel(self, s: ArmState, cmd_vel, cmd_brightness=None) -> ArmState:
        """End-effector twist -> damped pseudo-inverse joint velocities over
        ``substeps`` steps, after the contact guard; every ``drift_every``
        commands a 5-iteration IK toward the reached pose with z pinned
        (``fix_z``) and roll/pitch re-levelled (``level_ee``)."""
        c = _consts(s.q.device)
        cmd = self._guard(s, torch.as_tensor(cmd_vel, dtype=torch.float32,
                                             device=s.q.device))
        dt_sub = self.dt / self.substeps
        q, qd = s.q, None
        for _ in range(self.substeps):
            qd = torch.clamp(_dls_solve(geometric_jacobian(q), cmd), -c.qd_max, c.qd_max)
            q = torch.clamp(q + qd * dt_sub, c.q_min, c.q_max)
        count = s.count + 1
        pose = self._ee_pose(q)
        if self.drift_every > 0 and count % self.drift_every == 0:
            fix = pose
            if self.fix_z:
                fix = torch.cat([fix[:2], s.pose[2:3], fix[3:]])
            if self.level_ee:
                fix = torch.cat([fix[:3], c.level, fix[5:]])
            q = solve_ik(q, fix, iters=5)
            pose = self._ee_pose(q)
        b = s.brightness if cmd_brightness is None else torch.as_tensor(
            cmd_brightness, dtype=torch.float32, device=s.q.device)
        return dataclasses.replace(s, q=q, qdot=qd, pose=pose,
                                   vel=self._pose_rate(pose, s.pose), brightness=b,
                                   count=count, scene=self._apply_contact(s, pose))

    def step_pose(self, s: ArmState, cmd_pose, cmd_brightness=None) -> ArmState:
        """IK position control: a 20-iteration DLS IK toward the clipped
        target, then one joint step rate-limited to qd_max x dt."""
        c = _consts(s.q.device)
        target = torch.clamp(torch.as_tensor(cmd_pose, dtype=torch.float32,
                                             device=s.q.device),
                             self._lims[:, 0], self._lims[:, 1])
        q_goal = solve_ik(s.q, target, iters=20)
        dq = torch.clamp(q_goal - s.q, -c.qd_max * self.dt, c.qd_max * self.dt)
        q = torch.clamp(s.q + dq, c.q_min, c.q_max)
        pose = self._ee_pose(q)
        b = s.brightness if cmd_brightness is None else torch.as_tensor(
            cmd_brightness, dtype=torch.float32, device=s.q.device)
        return dataclasses.replace(s, q=q, qdot=dq / self.dt, pose=pose,
                                   vel=self._pose_rate(pose, s.pose), brightness=b,
                                   scene=self._apply_contact(s, pose))

    def observe(self, s: ArmState):
        """(pose, vel, force, image (H, W, 3)): the force is the contact
        wrench (3,) with dynamic contact (the escape path steers along its
        direction), else the contact force magnitude (1,)."""
        img = render_camera(s.scene, s.pose, s.brightness, self.img_hw)
        if self.dynamic_contact:
            force, _ = self._contact_wrench(s.pose, s.scene)
        else:
            force = self._contact_force(s.pose, s.scene)[None]
        return s.pose, s.vel, force, img

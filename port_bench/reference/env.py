"""Synthetic Franka-like environment (port of the ``free`` backend of
``ealv_tpu/sim/env.py``): velocity commands integrate the pose inside the
tray box, pose commands low-pass toward a clipped target, the wrist camera
renders, and a soft contact force rises when the end effector presses below
an object's height."""

from __future__ import annotations

import dataclasses
import functools

import torch

from .renderer import TrayScene, render_camera


@dataclasses.dataclass
class EnvState:
    pose: torch.Tensor  # (6,) x y z r p w (tray coords)
    vel: torch.Tensor  # (6,)
    brightness: torch.Tensor  # ()
    scene: TrayScene


@dataclasses.dataclass(frozen=True)
class SyntheticEnv:
    """``tray_lim``: ((lo, hi) x 6) pose box; ``dt`` the sim period."""

    tray_lim: tuple
    dt: float = 0.04
    img_hw: tuple = (180, 180)
    max_force: float = 30.0
    vel_alpha: float = 0.7  # EMA toward the commanded twist
    device: str = "cuda"

    # built once, on first use: a tensor made from Python data at every step
    # would be a host-to-device copy from pageable memory, which synchronises
    @functools.cached_property
    def _lims(self):
        return torch.tensor(self.tray_lim, dtype=torch.float32, device=self.device)

    @functools.cached_property
    def _free_z(self):
        """(6,) bool: every twist axis but z, which contact may block."""
        return torch.arange(6, device=self.device) != 2

    def init(self, pose0, scene: TrayScene | None = None, brightness=1.0) -> EnvState:
        return EnvState(
            pose=pose0.float(),
            vel=torch.zeros(6, device=self.device),
            brightness=torch.tensor(float(brightness), device=self.device),
            scene=scene if scene is not None else TrayScene.default(self.device),
        )

    def _contact_force(self, pose, scene: TrayScene):
        """Pressing below an object's height gives a normal force, clipped
        at max_force."""
        d2 = ((pose[None, :2] - scene.obj_xy) ** 2).sum(1)
        top = (torch.exp(-0.5 * d2 / scene.obj_radius ** 2) * scene.obj_height).max()
        return ((top - pose[2]).clamp(min=0.0) * 500.0).clamp(0.0, self.max_force)

    def step_vel(self, s: EnvState, cmd_vel, cmd_brightness=None) -> EnvState:
        """Velocity command with an EMA ramp and force-aware clipping: under
        high force the downward z command is dropped."""
        force = self._contact_force(s.pose, s.scene)
        blocked = (force > 0.75 * self.max_force) & (cmd_vel[2] < 0)
        cmd_vel = torch.where(self._free_z | ~blocked, cmd_vel, torch.zeros_like(cmd_vel))
        vel = self.vel_alpha * cmd_vel + (1 - self.vel_alpha) * s.vel
        lims = self._lims
        pose = torch.clamp(s.pose + vel * self.dt, lims[:, 0], lims[:, 1])
        b = s.brightness if cmd_brightness is None else cmd_brightness
        return dataclasses.replace(s, pose=pose, vel=vel, brightness=b)

    def observe(self, s: EnvState):
        """(pose, vel, force (1,), image (H, W, 3))."""
        img = render_camera(s.scene, s.pose, s.brightness, self.img_hw)
        force = self._contact_force(s.pose, s.scene)
        return s.pose, s.vel, force[None], img

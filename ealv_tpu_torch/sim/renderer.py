"""Synthetic tray renderer, the simulator's wrist camera (port of
``ealv_tpu/sim/renderer.py``): pinhole rays from the end-effector pose hit
the tray plane and sample a procedural radiance field (textured ground and
coloured objects with height)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TrayScene(NamedTuple):
    """K blob objects on a checkered ground."""

    obj_xy: torch.Tensor  # (K, 2) centres (tray coords)
    obj_radius: torch.Tensor  # (K,)
    obj_height: torch.Tensor  # (K,)
    obj_color: torch.Tensor  # (K, 3) RGB
    ground_color: torch.Tensor  # (3,)
    checker_scale: float = 12.0

    @classmethod
    def default(cls, device="cuda"):
        """Two objects: a yellow round one and a taller green one."""
        t = lambda v: torch.tensor(v, device=device)
        return cls(
            obj_xy=t([[0.42, -0.06], [0.53, 0.07]]),
            obj_radius=t([0.035, 0.03]),
            obj_height=t([0.22, 0.25]),
            obj_color=t([[0.95, 0.85, 0.1], [0.2, 0.7, 0.3]]),
            ground_color=t([0.45, 0.35, 0.3]),
        )

    @classmethod
    def make(cls, k: int, seed: int = 0, device="cuda"):
        """K objects on a jittered ring inside the tray (so every pair stays
        apart) with distinct colours, radii and heights; drawn with numpy
        from ``seed``, the same scene as the JAX package's ``make``."""
        rng = np.random.default_rng(seed)
        cx, cy, r0 = 0.475, 0.0, 0.065
        ang = 2 * np.pi * (np.arange(k) / k) + rng.uniform(-0.2, 0.2, k)
        xy = np.stack([cx + r0 * np.cos(ang), cy + r0 * np.sin(ang)], 1)
        hues = np.linspace(0.0, 1.0, k, endpoint=False)
        colors = np.stack([0.5 + 0.45 * np.cos(2 * np.pi * (hues + s))
                           for s in (0.0, 1 / 3, 2 / 3)], 1)
        t = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
        return cls(
            obj_xy=t(xy),
            obj_radius=t(0.026 + 0.012 * rng.random(k)),
            obj_height=t(0.21 + 0.05 * rng.random(k)),
            obj_color=t(colors),
            ground_color=t([0.45, 0.35, 0.3]),
        )

    def move_objects(self, tray_lim_xy, generator: torch.Generator | None = None,
                     xy=None):
        """Place the objects uniformly in ``tray_lim_xy`` (2, 2), drawn from
        ``generator`` unless ``xy`` (K, 2) feeds the draw in [0, 1)."""
        if xy is None:
            xy = torch.rand(self.obj_xy.shape, generator=generator,
                            device=self.obj_xy.device)
        lo, hi = tray_lim_xy[:, 0], tray_lim_xy[:, 1]
        return self._replace(obj_xy=xy * (hi - lo) + lo)


def _radiance(scene: TrayScene, u, v):
    """Colour and height of the tray surface at world (u, v)."""
    cs = scene.checker_scale
    checker = 0.5 + 0.5 * torch.sin(u * cs) * torch.sin(v * cs)
    base = scene.ground_color[None, None, :] * (0.7 + 0.3 * checker[..., None])
    d2 = (u[..., None] - scene.obj_xy[:, 0]) ** 2 + (v[..., None] - scene.obj_xy[:, 1]) ** 2
    w = torch.exp(-0.5 * d2 / scene.obj_radius[None, None, :] ** 2)  # (..., K)
    height = (w * scene.obj_height[None, None, :]).amax(-1)
    obj_rgb = torch.einsum("...k,kc->...c", w, scene.obj_color)
    w_sum = w.sum(-1, keepdim=True)
    w_tot = w_sum.clamp(0.0, 1.0)
    color = base * (1.0 - w_tot) + obj_rgb * w_tot.clamp(max=1.0) \
        / w_sum.clamp(min=1e-6) * w_tot
    return color, height


def render_camera(scene: TrayScene, pose, brightness=1.0, img_hw=(180, 180),
                  fov: float = 1.0):
    """(H, W, 3) image in [0, 1] from the camera at ``pose`` (x, y, z, roll,
    pitch, yaw) in tray coords; brightness scales the illumination."""
    x, y, z = pose[0], pose[1], pose[2].clamp(min=0.02)
    roll, pitch, yaw = pose[3], pose[4], pose[5]
    h_pix, w_pix = img_hw
    half = math.tan(fov / 2)
    iy = torch.linspace(-half, half, h_pix, device=pose.device)
    ix = torch.linspace(-half, half, w_pix, device=pose.device)
    py, px = torch.meshgrid(iy, ix, indexing="ij")

    dx = px + torch.tan(pitch)
    dy = py + torch.tan(roll)
    c, s = torch.cos(yaw), torch.sin(yaw)
    u = x + z * (c * dx - s * dy)
    v = y + z * (s * dx + c * dy)

    color, height = _radiance(scene, u, v)
    scale = (height / z).clamp(0.0, 0.9)  # tall objects look larger up close
    color = color * (1.0 + 0.8 * scale[..., None])
    vignette = 1.0 - 0.25 * (px ** 2 + py ** 2)
    illum = brightness * vignette / (1.0 + 0.5 * z)
    return (color * illum[..., None]).clamp(0.0, 1.0)

"""Collect a grid or circular sweep of (pose, image, force) samples from the
synthetic scene with the PyTorch port (port of
``scripts/collect_test_set.py``: the same flags and npz keys).

    python -m ealv_tpu_torch.scripts.collect_test_set --pattern grid --n 25 --out test_set.npz

The scene renders on ``--device`` (default ``cuda``); pass ``--device cpu``
for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..sim import SyntheticEnv, TrayScene
from ..utils.config import TRAY_LIM
from ..utils.trajectories import circular_traj, grid_traj


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.collect_test_set",
                                 description="Collect a sweep test set with the port.")
    ap.add_argument("--pattern", choices=["grid", "circle"], default="grid")
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--out", default="test_set.npz")
    ap.add_argument("--z", type=float, default=0.35)
    ap.add_argument("--img", type=int, default=180)
    ap.add_argument("--device", default="cuda", help="torch device of the renderer")
    return ap


def collect(pattern: str = "grid", n: int = 25, z: float = 0.35, img: int = 180,
            device="cuda"):
    """(poses (n, 6), images (n, img, img, 3), forces (n, 1)) as numpy, at
    z height, roll 3.14, over the tray's x-y sweep."""
    xc, yc = sum(TRAY_LIM["x"]) / 2, sum(TRAY_LIM["y"]) / 2
    width = TRAY_LIM["x"][1] - TRAY_LIM["x"][0]
    if pattern == "grid":
        xy = grid_traj(grid_size=width, num_points=n, center=(xc, yc))
    else:
        xy = circular_traj(radius=width / 3, num_points=n, center=(xc, yc), start=0)
    env = SyntheticEnv(tray_lim=tuple(TRAY_LIM[s] for s in "xyzrpw"), img_hw=(img, img),
                       device=device)
    scene = TrayScene.default(device)
    poses, images, forces = [], [], []
    for x, y in xy:
        s = env.init(torch.tensor([x, y, z, 3.14, 0.0, 0.0], device=device), scene)
        pose, _, force, image = env.observe(s)
        poses.append(pose)
        images.append(image)
        forces.append(force)
    stack = lambda ts: torch.stack(ts).cpu().numpy()
    return stack(poses), stack(images), stack(forces)


def main(argv=None):
    args = build_parser().parse_args(argv)
    poses, images, forces = collect(args.pattern, args.n, args.z, args.img, args.device)
    np.savez_compressed(args.out, poses=poses, images=images, forces=forces)
    print(f"wrote {len(poses)} samples to {args.out}")


if __name__ == "__main__":
    main()

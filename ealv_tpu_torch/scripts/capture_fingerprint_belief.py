"""Drive to each fingerprint's belief maximum and photograph it, with the
PyTorch port (port of ``scripts/capture_fingerprint_belief.py``): verify a
localization by going there.

    python -m ealv_tpu_torch.scripts.capture_fingerprint_belief --beliefs beliefs.npz --out caps/

Each belief's peak (robot coords over the states) is mapped to a tray pose
at height ``--z``, reached with 30 pose-controller steps, and the pose and
camera image are saved to {out}/belief_cap_{k}.npz.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..sim import SyntheticEnv, TrayScene
from ..utils.config import ExperimentConfig, TRAY_LIM


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ealv_tpu_torch.scripts.capture_fingerprint_belief",
        description="Photograph each belief's peak with the port.")
    ap.add_argument("--beliefs", required=True,
                    help="npz of per-fingerprint belief grids (io.save_beliefs)")
    ap.add_argument("--out", default="belief_caps")
    ap.add_argument("--z", type=float, default=0.3)
    ap.add_argument("--device", default="cuda", help="torch device of the renderer")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    data = np.load(args.beliefs, allow_pickle=False)
    grids, priors = data["grids"], data["priors"]  # (K, G, d), (K, G)
    cfg = ExperimentConfig()
    env = SyntheticEnv(tray_lim=tuple(TRAY_LIM[s] for s in "xyzrpw"), img_hw=cfg.image_dim[:2],
                       device=args.device)
    scene = TrayScene.default(args.device)
    rl, tl = cfg.robot_lim, cfg.tray_lim
    os.makedirs(args.out, exist_ok=True)
    paths = []
    for k in range(grids.shape[0]):
        peak = grids[k][int(np.argmax(priors[k]))]
        rs = np.zeros(len(cfg.states), np.float32)
        rs[: len(peak)] = peak[: len(rs)]
        tray = (rs - rl[:, 0]) / (rl[:, 1] - rl[:, 0]) * (tl[:, 1] - tl[:, 0]) + tl[:, 0]
        pose6 = np.array([tray[0], tray[1], args.z, 3.14, 0.0,
                          tray[2] if len(tray) > 2 else 0.0], np.float32)
        target = torch.as_tensor(pose6, device=args.device)
        s = env.init(target, scene)
        for _ in range(30):  # the pose controller's approach
            s = env.step_pose(s, target)
        pose, _, _, img = env.observe(s)
        path = os.path.join(args.out, f"belief_cap_{k}.npz")
        np.savez_compressed(path, pose=pose.cpu().numpy(), image=img.cpu().numpy())
        print(f"fingerprint {k}: belief peak (robot) {np.round(peak[:2], 3)} -> "
              f"tray pose {np.round(pose6[:2], 3)}, image captured")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()

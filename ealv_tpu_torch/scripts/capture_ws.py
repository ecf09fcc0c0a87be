"""Photograph the workspace from above the tray centre with the PyTorch
port (port of ``scripts/capture_ws.py``).

    python -m ealv_tpu_torch.scripts.capture_ws --out workspace.png

Writing the PNG needs matplotlib, which is imported only here.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..sim import TrayScene
from ..sim.renderer import render_camera
from ..utils.config import TRAY_LIM


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.capture_ws",
                                 description="Overhead photo of the workspace with the port.")
    ap.add_argument("--out", default="workspace.png")
    ap.add_argument("--img", type=int, default=360)
    ap.add_argument("--z", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="torch device of the renderer")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xc, yc = sum(TRAY_LIM["x"]) / 2, sum(TRAY_LIM["y"]) / 2
    pose = torch.tensor([xc, yc, args.z, 0.0, 0.0, 0.0], device=args.device)
    img = render_camera(TrayScene.default(args.device), pose, brightness=1.0,
                        img_hw=(args.img, args.img), fov=1.4)
    plt.imsave(args.out, np.clip(img.cpu().numpy(), 0, 1))
    print(f"workspace photo ({args.img}x{args.img}, z={args.z}) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()

"""Capture fingerprints at given locations with the PyTorch port (port of
``scripts/build_manual_fingerprints.py``).

    python -m ealv_tpu_torch.scripts.build_manual_fingerprints \\
        --config runs/synth/entklerg_0000/config.yaml \\
        --ckpt runs/synth/entklerg_0000/checkpoints/postexplr \\
        --centers='-0.4,-0.4,0;0.4,0.5,0' --out fingerprints/

The checkpoint is one of the port's run entry (``run_experiment``); each
capture goes to {out}/manual_{i}_{mode}.npz.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..fingerprint.capture import capture_fingerprint
from ..runtime import Experiment
from ..runtime.checkpoint import load_checkpoint
from ..utils.config import ExperimentConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ealv_tpu_torch.scripts.build_manual_fingerprints",
        description="Capture fingerprints at manual locations with the port.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--centers", required=True,
                    help="semicolon-separated robot-coord centers, e.g. '-0.4,-0.4,0;0.4,0.5,0' "
                         "(one argument, so that negative coordinates survive argparse)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", default="sphere", choices=["sphere", "cone", "cylinder"])
    ap.add_argument("--out", default="fingerprints")
    ap.add_argument("--device", default="cuda", help="torch device of the captures")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = ExperimentConfig.from_yaml(args.config)
    exp = Experiment(cfg, device=args.device)
    es = load_checkpoint(args.ckpt, exp.init(seed=0))
    os.makedirs(args.out, exist_ok=True)
    paths = []
    for i, c in enumerate(args.centers.split(";")):
        center = np.asarray([float(v) for v in c.split(",")], np.float32)
        fp = capture_fingerprint(es.model, cfg, center, num_steps=args.steps, mode=args.mode,
                                 seed=i, device=args.device)
        path = os.path.join(args.out, f"manual_{i}_{args.mode}.npz")
        np.savez_compressed(path, **fp)
        print(f"fingerprint {i}: {fp['x'].shape[0]} samples -> {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()

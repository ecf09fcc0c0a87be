"""Replay a finished run offline with the PyTorch port (port of
``scripts/replay_run.py``): reload its latest checkpoint and its metrics,
then redraw the training curves and the camera view with the model's
reconstruction at the checkpointed state, and, with ``--test-set``, the
model-evaluation panels of a ``collect_test_set`` npz.

    python -m ealv_tpu_torch.scripts.replay_run --run runs/synth/entklerg_0000 [--test-set ts.npz]

Writes replay_training.png, replay_view.png (and eval_*.png) into the run
dir or ``--out``; needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..runtime import Experiment
from ..runtime.checkpoint import latest_checkpoint, load_checkpoint
from ..runtime.evaluate import eval_report
from ..utils.config import ExperimentConfig
from ..viz import ExplorationPlotter, TrainingPlotter


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.replay_run",
                                 description="Redraw a finished run's figures.")
    ap.add_argument("--run", required=True, help="run directory")
    ap.add_argument("--test-set", default=None,
                    help="optional collect_test_set npz for the model evaluation")
    ap.add_argument("--out", default=None, help="output dir (default: the run dir)")
    ap.add_argument("--device", default="cuda", help="torch device of the model")
    return ap


def main(argv=None):
    """Returns the paths drawn and, with ``--test-set``, the metrics."""
    args = build_parser().parse_args(argv)
    out = args.out or args.run
    cfg = ExperimentConfig.from_yaml(os.path.join(args.run, "config.yaml"))
    exp = Experiment(cfg, device=args.device)
    ck = latest_checkpoint(os.path.join(args.run, "checkpoints"))
    if ck is None:
        print("no checkpoint found", file=sys.stderr)
        raise SystemExit(1)
    es = load_checkpoint(ck, exp.init(seed=cfg.seed))
    print(f"loaded {ck} (step {es.explr_step})")
    paths = []

    mpath = os.path.join(args.run, "metrics.npz")
    if os.path.exists(mpath):
        series = dict(np.load(mpath))
        paths.append(TrainingPlotter(out).render(series, name="replay_training.png"))
        print("rendered replay_training.png")

    # the newest sample and the model's reconstruction of it
    x_last, y_last, _ = es.buf.get_last()
    with torch.no_grad():
        o = es.model(x_last[None], y_last[None], train=False)
    paths.append(ExplorationPlotter(out, robot_lim=cfg.robot_lim[:2]).render(
        image=y_last, img_pred=o["img_pred"][0], z_mu=o["z_mu"][0],
        z_var=torch.exp(o["z_logvar"][0]), step=es.explr_step, name="replay_view.png"))
    print("rendered replay_view.png")

    metrics = None
    if args.test_set:
        metrics = eval_report(es.model, args.test_set, out)
        print(f"test-set eval: MSE {metrics['mean_mse']:.4f}, "
              f"active units {metrics['active_units']}")
    return paths, metrics


if __name__ == "__main__":
    main()

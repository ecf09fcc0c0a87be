"""Method-comparison matrix with the PyTorch port (port of
``scripts/batch_tests.py``): one run of the port's run entry per
exploration method and seed, each in its own process.

    python -m ealv_tpu_torch.scripts.batch_tests --steps 200 --seeds 0 1 2 --small
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# the directory that holds the ealv_tpu_torch package
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.batch_tests",
                                 description="Run every method across seeds.")
    ap.add_argument("--methods", nargs="+",
                    default=["entklerg", "unifklerg", "uniform", "randomWalk"])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="runs")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device of the runs")
    return ap


def commands(args) -> list:
    """The run entry's command line for each (seed, method), in run order."""
    cmds = []
    for seed in args.seeds:
        for method in args.methods:
            cmd = [sys.executable, "-m", "ealv_tpu_torch.scripts.run_experiment",
                   "--method", method, "--seed", str(seed), "--steps", str(args.steps),
                   "--out", args.out, "--device", args.device]
            if args.small:
                cmd.append("--small")
            cmds.append(cmd)
    return cmds


def main(argv=None) -> list:
    """Runs every command; a failed run stops the matrix. Returns the
    commands run."""
    args = build_parser().parse_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    cmds = commands(args)
    for cmd in cmds:
        print("==>", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True, env=env)
    return cmds


if __name__ == "__main__":
    main()

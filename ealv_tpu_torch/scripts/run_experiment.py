"""Run one online-learning experiment with the PyTorch port (port of the
fused, chunked path of ``scripts/run_experiment.py``).

    python -m ealv_tpu_torch.scripts.run_experiment --method entklerg --steps 300
    python -m ealv_tpu_torch.scripts.run_experiment --small --device cpu --steps 20
    python -m ealv_tpu_torch.scripts.run_experiment --steps 300 --resume
    python -m ealv_tpu_torch.scripts.run_experiment --method randomWalk --states xywb

Writes to the run dir ({out}/synth/{method}_{seed:04d}/): config.yaml,
log.txt, metrics.npz (+ metrics_summary.json), checkpoints/step_* every
``--save-rate`` steps and at the end, and checkpoints/postexplr after the
post-exploration training. ``--device`` (default ``cuda``) is where the run
goes; the port never moves to the CPU by itself.

Differences from the JAX script: exploration runs exactly ``--steps``
steps (full ``--chunk`` chunks, then the rest) and post-training stops
exactly at ``num_steps * target_learning_rate`` trainer calls, since nothing
here is compiled for a fixed chunk length. The figures are not drawn. The
force variant (``learn_force``) and the z-ensemble (``use_z_ensemble``) are
switched on in a ``--config`` yaml, as in the JAX script. Options that are
not ported (arm backends, the host loop, panels, the dashboard, the
profiler, the clustering monitor, entropy slices) are rejected, never
ignored.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..utils.config import ExperimentConfig
from ..runtime import Experiment, ExperimentState
from ..runtime.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..runtime.metrics import MetricsLog, run_dir

SMALL = dict(
    image_dim=(48, 48, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
    cnn_channels=(10, 10), hidden_dim=(256, 128), z_dim=12,
    num_target_samples=512, num_traj_samples=512,
    traj_buffer_capacity=1024, buffer_capacity=1024, batch_size=32,
    num_learning_opt=10,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ealv_tpu_torch.scripts.run_experiment",
        description="Explore-and-learn run of the PyTorch port.")
    ap.add_argument("--method", default="entklerg",
                    choices=["entklerg", "unifklerg", "uniform", "randomWalk"],
                    help="exploration method: the ergodic planner (entklerg, "
                         "unifklerg) or a baseline explorer (uniform, randomWalk)")
    ap.add_argument("--states", default="xyw",
                    help="explored states, a subset of 'xyzrpwb' (b: brightness)")
    ap.add_argument("--backend", default=None,
                    choices=["free", "arm", "arm-dynamic", "arm-dynamic-soft"],
                    help="simulator backend; only 'free' is ported")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="runs")
    ap.add_argument("--config", default=None, help="yaml config to load")
    ap.add_argument("--chunk", type=int, default=25,
                    help="steps between progress lines and checkpoint checks")
    ap.add_argument("--small", action="store_true",
                    help="small model/images for quick runs")
    ap.add_argument("--train-calls", type=int, default=1)
    ap.add_argument("--train-every", type=int, default=1,
                    help="run a trainer call only every k-th control step")
    ap.add_argument("--save-rate", type=int, default=200)
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in the run dir")
    ap.add_argument("--post-train", dest="post_train", action="store_true",
                    default=True,
                    help="after exploration, keep training until learning_ind "
                         ">= num_steps * target_learning_rate and save a "
                         "'postexplr' checkpoint (default on)")
    ap.add_argument("--no-post-train", dest="post_train", action="store_false")
    ap.add_argument("--device", default="cuda", help="torch device of the run")
    # options of the JAX script that are not ported: rejected when given
    ap.add_argument("--cluster-every", type=int, default=0, help="not ported")
    ap.add_argument("--host-loop", action="store_true", help="not ported")
    ap.add_argument("--panel", action="store_true", help="not ported")
    ap.add_argument("--web-panel", type=int, default=-1, help="not ported")
    ap.add_argument("--dash-every", type=int, default=0, help="not ported")
    ap.add_argument("--profile", action="store_true", help="not ported")
    ap.add_argument("--entropy-slices", action="store_true", help="not ported")
    return ap


def _reject_unported(ap: argparse.ArgumentParser, args) -> None:
    if args.backend not in (None, "free"):
        ap.error(f"--backend {args.backend} is not ported yet")
    for flag, on in (("--cluster-every", args.cluster_every > 0),
                     ("--host-loop", args.host_loop), ("--panel", args.panel),
                     ("--web-panel", args.web_panel >= 0),
                     ("--dash-every", args.dash_every > 0),
                     ("--profile", args.profile),
                     ("--entropy-slices", args.entropy_slices)):
        if on:
            ap.error(f"{flag} is not ported yet")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: torch.cuda.is_available() is False")


def make_config(args) -> ExperimentConfig:
    overrides = dict(explr_method=args.method, states=args.states,
                     num_steps=args.steps, seed=args.seed)
    if args.backend:
        overrides["sim_backend"] = args.backend
    if args.small:
        overrides.update(SMALL)
    if args.config:
        return ExperimentConfig.from_yaml(args.config, **overrides)
    return ExperimentConfig(**overrides)


def make_experiment(cfg: ExperimentConfig, args) -> Experiment:
    return Experiment(cfg, train_calls_per_tick=args.train_calls,
                      train_every=args.train_every, device=args.device)


def _last_loss(losses) -> float:
    losses = losses[losses != 0]  # skipped trainer calls report zero
    return float(losses[-1]) if losses.size else float("nan")


def run(exp: Experiment, args, dirp: str, ml: MetricsLog,
        es: ExperimentState | None = None) -> ExperimentState:
    """The run loop: start from ``es`` (or ``exp.init(seed)``, or the
    latest checkpoint with ``--resume``), explore in chunks with periodic
    checkpoints, post-train to the learning-ratio target, and save the
    final and the ``postexplr`` checkpoints. Returns the final state."""
    cfg = exp.cfg
    ck_dir = os.path.join(dirp, "checkpoints")
    if es is None:
        es = exp.init(seed=args.seed)
    if args.resume:
        ck = latest_checkpoint(ck_dir)
        if ck:
            es = load_checkpoint(ck, es)
            ml.write_to_log(f"resumed from {ck} at step {es.explr_step}")
        else:
            ml.write_to_log("no checkpoint found; starting fresh")

    t0 = time.time()
    start = es.explr_step
    while es.explr_step < args.steps:
        before = es.explr_step
        es, infos = exp.run_chunk(es, min(args.chunk, args.steps - before))
        infos = {k: infos[k].float().cpu().numpy()
                 for k in ("loss", "ergodic_cost", "beta", "gamma")}
        ml.push_tick_info(infos)
        ml.progress(es.explr_step, es.learning_ind, _last_loss(infos["loss"]))
        if es.explr_step // args.save_rate > before // args.save_rate:
            save_checkpoint(ck_dir, es, step=es.explr_step)
    wall = max(time.time() - t0, 1e-9)
    ml.write_to_log(f"done: {es.explr_step} steps in {wall:.0f}s "
                    f"({(es.explr_step - start) / wall:.2f} Hz)")

    if args.post_train:
        # post-exploration training: train until the learning-ratio target
        # is met, then save the postexplr checkpoint, the one the
        # downstream (clustering, fingerprint) stages load
        target = int(cfg.num_steps * cfg.target_learning_rate)
        deficit = target - es.learning_ind
        if deficit > 0:
            t1 = time.time()
            while es.learning_ind < target:
                n = min(args.chunk, target - es.learning_ind)
                es, pinfos = exp.post_train_chunk(es, n)
                pinfos = {k: v.float().cpu().numpy() for k, v in pinfos.items()}
                ml.push_tick_info(pinfos)
                ml.progress(es.explr_step, es.learning_ind, float(pinfos["loss"][-1]))
            ml.write_to_log(
                f"post-exploration training: {deficit} trainer calls in "
                f"{time.time() - t1:.0f}s -> learning_ind {es.learning_ind}/{target}")
        else:
            ml.write_to_log("post-exploration training: ratio already met")
        save_checkpoint(ck_dir, es, step=es.explr_step)
        ck = save_checkpoint(os.path.join(ck_dir, "postexplr"), es)
        ml.write_to_log(f"postexplr checkpoint -> {ck}")
    else:
        save_checkpoint(ck_dir, es, step=es.explr_step)
    ml.save()
    return es


def main(argv=None) -> ExperimentState:
    ap = build_parser()
    args = ap.parse_args(argv)
    _reject_unported(ap, args)
    cfg = make_config(args)
    dirp = run_dir(args.out, "synth", args.method, args.seed)
    ml = MetricsLog(dirp)
    cfg.to_yaml(os.path.join(dirp, "config.yaml"))
    es = run(make_experiment(cfg, args), args, dirp, ml)
    print(f"run dir: {dirp}")
    return es


if __name__ == "__main__":
    main()

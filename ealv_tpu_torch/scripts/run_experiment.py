"""Run one online-learning experiment with the PyTorch port (port of
``scripts/run_experiment.py``).

    python -m ealv_tpu_torch.scripts.run_experiment --method entklerg --steps 300
    python -m ealv_tpu_torch.scripts.run_experiment --small --device cpu --steps 20
    python -m ealv_tpu_torch.scripts.run_experiment --steps 300 --resume
    python -m ealv_tpu_torch.scripts.run_experiment --method randomWalk --states xywb
    python -m ealv_tpu_torch.scripts.run_experiment --backend arm-dynamic --host-loop --panel
    python -m ealv_tpu_torch.scripts.run_experiment --steps 300 --cluster-every 50

Writes to the run dir ({out}/synth/{method}_{seed:04d}/): config.yaml,
log.txt, metrics.npz (+ metrics_summary.json), checkpoints/step_* every
``--save-rate`` steps and at the end, and checkpoints/postexplr after the
post-exploration training. ``--device`` (default ``cuda``) is where the run
goes; the port never moves to the CPU by itself.

``--backend`` picks the simulator: the free-flying end effector, or the
7-DOF arm (``arm``; ``arm-dynamic`` adds penalty contact mechanics,
``arm-dynamic-soft`` soft objects). ``--host-loop`` drives the experiment
through a ``SyntheticBridge`` with the robustness layer (stuck escape, goal
seeking to the start pose, the pause/recover heartbeat, SIGINT/SIGTERM,
saves on request) instead of stepping the env directly; ``--panel``
attaches the stdin control panel to it. ``--cluster-every N`` runs the
clustering monitor after the chunk that crosses each multiple of N steps
(clusters/cluster_log.csv; a checkpoint in cluster_checkpoints/ when the
clusters are stable).

Differences from the JAX script: exploration runs exactly ``--steps``
steps (full ``--chunk`` chunks, then the rest) and post-training stops
exactly at ``num_steps * target_learning_rate`` trainer calls, since nothing
here is compiled for a fixed chunk length. The figures are not drawn. The
force variant (``learn_force``) and the z-ensemble (``use_z_ensemble``) are
switched on in a ``--config`` yaml, as in the JAX script. Options that are
not ported (the web panel, the dashboard, the profiler, entropy slices) are
rejected, never ignored.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..utils.config import ExperimentConfig
from ..runtime import Experiment, ExperimentState, HostLoopRunner
from ..runtime.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..runtime.metrics import MetricsLog, run_dir
from ..runtime.panel import ControlPanel
from ..runtime.watchdog import GracefulKiller

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
                    help="simulator backend: 'free' (free-flying end effector), 'arm' "
                         "(7-DOF kinematic arm with Jacobian pseudo-inverse velocity "
                         "control, drift and joint-limit failures), 'arm-dynamic' (+ "
                         "penalty contact mechanics), 'arm-dynamic-soft' (soft objects)")
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
    ap.add_argument("--cluster-every", type=int, default=0,
                    help="run the online clustering monitor every N exploration steps; "
                         "a cluster checkpoint is saved when the clusters are stable")
    ap.add_argument("--host-loop", action="store_true",
                    help="drive the experiment through a RobotBridge with the "
                         "robustness layer (stuck escape, goal seeking, pause/recover "
                         "heartbeat) instead of stepping the env directly")
    ap.add_argument("--panel", action="store_true",
                    help="attach the stdin control panel (pause/resume/save/mode "
                         "commands) to the host loop; needs --host-loop")
    # options of the JAX script that are not ported: rejected when given
    ap.add_argument("--web-panel", type=int, default=-1, help="not ported")
    ap.add_argument("--dash-every", type=int, default=0, help="not ported")
    ap.add_argument("--profile", action="store_true", help="not ported")
    ap.add_argument("--entropy-slices", action="store_true", help="not ported")
    return ap


def _reject_unported(ap: argparse.ArgumentParser, args) -> None:
    if args.panel and not args.host_loop:
        ap.error("--panel drives the host loop: add --host-loop")
    for flag, on in (("--web-panel", args.web_panel >= 0),
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


def make_monitor(exp: Experiment, es: ExperimentState, dir_path: str | None = None):
    """The clustering monitor over the live model ``es.model``: 600 samples
    moved by ``optimize_samples`` under the planner's barrier, mean shift at
    bandwidth 0.3 (the JAX script's settings)."""
    from ..control.barrier import setup_barrier
    from ..fingerprint.monitor import ClusteringMonitor
    cfg = exp.cfg
    pos_states = "".join(s for s in cfg.states if s == s.lower())
    barrier, _ = setup_barrier(pos_states, exp.robot_lim, exp.robot_ctrl_lim[: len(pos_states)],
                               list(range(len(pos_states))))
    return ClusteringMonitor(model=es.model, robot_lim=cfg.robot_lim, num_pts=600,
                             dir_path=dir_path,
                             cluster_kwargs=dict(use_optimize_samples=True, barrier=barrier,
                                                 bandwidth=0.3))


def monitor_update(monitor, es: ExperimentState, seed: int, checkpoint_fn=None):
    """One monitor pass seeded by the last six pushed samples, drawing from
    a generator seeded with ``seed``; returns (result, stable)."""
    n = es.buf.size
    gen = torch.Generator(device=es.buf.x.device).manual_seed(seed)
    return monitor.update(es.buf.x[max(0, n - 6):n], es.buf.y[max(0, n - 6):n],
                          es.explr_step, checkpoint_fn=checkpoint_fn, generator=gen)


def run_host_loop(exp: Experiment, args, dirp: str, ml: MetricsLog,
                  es: ExperimentState) -> ExperimentState:
    """Exploration through a ``SyntheticBridge`` and ``HostLoopRunner``:
    goal-seek to the start pose, then exactly ``--steps`` steps in blocks
    of ``--chunk``; SIGINT/SIGTERM stop it between steps, panel save
    requests write a checkpoint. No post-training (as in the JAX script);
    saves the final checkpoint."""
    from ..hw.bridge import SyntheticBridge
    ck_dir = os.path.join(dirp, "checkpoints")
    t0 = time.time()
    bridge = SyntheticBridge(exp.env, es.env)
    runner = HostLoopRunner(exp, bridge, metrics=ml, killer=GracefulKiller(),
                            save_fn=lambda s: save_checkpoint(ck_dir, s, step=s.explr_step))
    if args.panel:
        ControlPanel(runner.hooks()).start()
    runner.drive_to_start(bridge.klerg_start_pose(), yaw_index=5)
    remaining = max(0, args.steps - es.explr_step)
    done = 0
    while done < remaining:
        n = min(max(1, args.chunk), remaining - done)
        es = runner.run(es, n)
        done += n
        ml.progress(es.explr_step, es.learning_ind, float("nan"))
        if runner.killer.kill_now:
            break
    wall = max(time.time() - t0, 1e-9)
    ml.write_to_log(f"host-loop done: {es.explr_step} steps in {wall:.0f}s "
                    f"({es.explr_step / wall:.2f} Hz); events: {runner.events or 'none'}")
    ml.save()
    save_checkpoint(ck_dir, es, step=es.explr_step)
    return es


def run(exp: Experiment, args, dirp: str, ml: MetricsLog,
        es: ExperimentState | None = None) -> ExperimentState:
    """The run loop: start from ``es`` (or ``exp.init(seed)``, or the
    latest checkpoint with ``--resume``), explore in chunks with periodic
    checkpoints (and the clustering monitor with ``--cluster-every``),
    post-train to the learning-ratio target, and save the final and the
    ``postexplr`` checkpoints. With ``--host-loop`` the exploration goes
    through ``run_host_loop`` instead. Returns the final state."""
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
    if args.host_loop:
        return run_host_loop(exp, args, dirp, ml, es)
    monitor = None
    if args.cluster_every > 0:
        monitor = make_monitor(exp, es, os.path.join(dirp, "clusters"))

    t0 = time.time()
    start = es.explr_step
    c = 0
    while es.explr_step < args.steps:
        before = es.explr_step
        es, infos = exp.run_chunk(es, min(args.chunk, args.steps - before))
        infos = {k: infos[k].float().cpu().numpy()
                 for k in ("loss", "ergodic_cost", "beta", "gamma")}
        ml.push_tick_info(infos)
        ml.progress(es.explr_step, es.learning_ind, _last_loss(infos["loss"]))
        if es.explr_step // args.save_rate > before // args.save_rate:
            save_checkpoint(ck_dir, es, step=es.explr_step)
        if monitor and es.explr_step // args.cluster_every > before // args.cluster_every:
            res, stable = monitor_update(
                monitor, es, 42 + c, checkpoint_fn=lambda step: save_checkpoint(
                    os.path.join(dirp, "cluster_checkpoints"), es, step=step))
            means = np.round(res.means[:, :2].astype(np.float64), 2).tolist()
            ml.write_to_log(f"clusters @ {es.explr_step}: {means} stable={stable}")
        c += 1
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
    if monitor:
        monitor.save_log()
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

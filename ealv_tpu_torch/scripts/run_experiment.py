"""Run one online-learning experiment with the PyTorch port (port of
``scripts/run_experiment.py``).

    python -m ealv_tpu_torch.scripts.run_experiment --method entklerg --steps 300
    python -m ealv_tpu_torch.scripts.run_experiment --small --device cpu --steps 20
    python -m ealv_tpu_torch.scripts.run_experiment --steps 300 --resume
    python -m ealv_tpu_torch.scripts.run_experiment --method randomWalk --states xywb
    python -m ealv_tpu_torch.scripts.run_experiment --backend arm-dynamic --host-loop --panel
    python -m ealv_tpu_torch.scripts.run_experiment --steps 300 --cluster-every 50
    python -m ealv_tpu_torch.scripts.run_experiment --steps 300 --dash-every 25 --web-panel 8080

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

``--web-panel PORT`` serves the browser control panel (pause, resume,
save and the other panel commands, beside the live dashboard frame) in both
loops; the chunked loop pauses and saves between chunks. ``--dash-every N``
redraws ``dashboard.png`` (``dashboard.html`` beside it) after the chunk
that crosses each multiple of N steps. ``--profile`` turns the tracer
(``runtime/tracing.py``) on for the run, writes a ``torch.profiler`` trace
of the second chunk (CPU and, on the card, CUDA activity, with the
program's spans) to ``profile/trace.json`` as a Chrome trace, and logs to
``log.txt`` each span's self time a tick over the chunks after that one,
and the device's wait by host span. ``--entropy-slices``
draws the entropy-slice figures after the run. The end-of-run figures
(``training.png``, ``final_view.png``) are drawn where matplotlib is
installed; where it is not, ``log.txt`` gets one line naming them, and
``--dash-every`` and ``--entropy-slices`` stop the run before it starts.

Differences from the JAX script: exploration runs exactly ``--steps``
steps (full ``--chunk`` chunks, then the rest) and post-training stops
exactly at ``num_steps * target_learning_rate`` trainer calls, since nothing
here is compiled for a fixed chunk length. The force variant
(``learn_force``) and the z-ensemble (``use_z_ensemble``) are switched on
in a ``--config`` yaml, as in the JAX script. Options the chosen loop would
not honour (the dashboard, the profiler and the slices with
``--host-loop``, which the JAX script ignores there) are rejected, never
ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from ..utils.config import ExperimentConfig
from ..runtime import Experiment, ExperimentState, HostLoopRunner, tracing
from ..runtime.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..runtime.metrics import MetricsLog, run_dir
from ..runtime.panel import ControlHooks, ControlPanel
from ..runtime.watchdog import GracefulKiller
from ..runtime.webpanel import WebPanel

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
    ap.add_argument("--web-panel", type=int, default=-1, metavar="PORT",
                    help="serve the browser control panel (pause/resume/save/mode/"
                         "brightness + live dashboard) on this port of 127.0.0.1 (0: "
                         "any free port); in both the chunked and the host loop")
    ap.add_argument("--dash-every", type=int, default=0,
                    help="redraw the live dashboard (dashboard.png / .html in the run "
                         "dir) every N exploration steps, between chunks")
    ap.add_argument("--profile", action="store_true",
                    help="trace the run's spans: a torch.profiler trace of the second "
                         "chunk to {run_dir}/profile/trace.json (Chrome trace format), and "
                         "each span's self time a tick after it in log.txt")
    ap.add_argument("--entropy-slices", action="store_true",
                    help="after the run, draw the entropy-slice figures (marginal "
                         "uncertainty fields per z-range variant) into the run dir")
    return ap


def _check_args(ap: argparse.ArgumentParser, args) -> None:
    """Stop on options the run cannot honour, before the run dir is made."""
    if args.panel and not args.host_loop:
        ap.error("--panel drives the host loop: add --host-loop")
    if args.web_panel > 65535:
        ap.error(f"--web-panel {args.web_panel}: not a TCP port")
    if args.host_loop:
        for flag, on in (("--dash-every", args.dash_every > 0),
                         ("--profile", args.profile),
                         ("--entropy-slices", args.entropy_slices)):
            if on:
                ap.error(f"{flag} runs in the chunked loop, not with --host-loop")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: torch.cuda.is_available() is False")
    if args.dash_every > 0 or args.entropy_slices:
        from ..viz.plotting import pyplot
        pyplot()  # ImportError naming matplotlib where it is missing


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
    n = int(es.buf.size)
    gen = torch.Generator(device=es.buf.x.device).manual_seed(seed)
    return monitor.update(es.buf.x[max(0, n - 6):n], es.buf.y[max(0, n - 6):n],
                          es.explr_step, checkpoint_fn=checkpoint_fn, generator=gen)


@contextlib.contextmanager
def _web_panel(args, hooks: ControlHooks, dirp: str, ml: MetricsLog):
    """The browser panel over ``hooks`` while the block runs (with
    ``--web-panel``); yields it, or None."""
    if args.web_panel < 0:
        yield None
        return
    web = WebPanel(hooks, run_dir=dirp, port=args.web_panel)
    web.start()
    ml.write_to_log(f"web panel: http://127.0.0.1:{web.port}/")
    try:
        yield web
    finally:
        web.stop()


def _profiler(device: torch.device):
    """A torch.profiler over the host and, on the card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def log_spans(ml: MetricsLog, first: int | None) -> None:
    """Log the tracer's split of the ticks from ``first`` on (those after
    the profiled chunk, which the profiler slows) and turn the tracer off."""
    last = tracing.ticks()
    if first is None or first >= last:
        ml.write_to_log("tracer: no chunk ran after the profiled one")
    else:
        tr = tracing.read(max(first, last - tracing.CAPACITY), last)
        ml.write_to_log(tracing.describe(tracing.summary(tr)))
        ml.write_to_log(f"tracer: stamps on the host clock within {tr.uncertainty_ns} ns "
                        f"(offset {tr.offset_ns} ns, drift since the run began "
                        f"{tr.drift_ns} ns)")
    tracing.disable()


def draw_figures(exp: Experiment, es: ExperimentState, dirp: str, ml: MetricsLog) -> list:
    """The end-of-run figures: the training curves and the final camera
    view. Where matplotlib is missing, one line in the log names them.
    Returns the paths drawn."""
    from ..viz import ExplorationPlotter, TrainingPlotter
    names = ["training.png", "final_view.png"]
    try:
        from ..viz.plotting import pyplot
        pyplot()
    except ImportError:
        ml.write_to_log(f"figures not drawn (matplotlib is not installed): {', '.join(names)}")
        return []
    series = {k: np.concatenate([np.atleast_1d(x) for x in v]) for k, v in ml.series.items()}
    _, _, _, img = exp.env.observe(es.env)
    return [TrainingPlotter(dirp).render(series, name=names[0]),
            ExplorationPlotter(dirp, robot_lim=exp.cfg.robot_lim[:2]).render(
                image=img, step=es.explr_step, name=names[1])]


def draw_entropy_slices(exp: Experiment, es: ExperimentState, dirp: str, ml: MetricsLog,
                        seed: int) -> list:
    """The entropy-slice figures of the final model over its replay ring,
    the draws from a generator seeded with ``seed``. Returns the paths."""
    from ..fingerprint.entropy import entropy_slices
    from ..viz import plot_entropy_slices
    cfg = exp.cfg
    gen = torch.Generator(device=es.buf.x.device).manual_seed(seed)
    slices = entropy_slices(
        es.model, es.buf, cfg.robot_lim, cfg.states, generator=gen,
        lim_scale=cfg.explr_robot_lim_scale if cfg.explr_robot_lim_scale > 1 else 1.15)
    paths = plot_entropy_slices(dirp, slices)
    for p in paths:
        ml.write_to_log(f"entropy slice -> {p}")
    return paths


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
    with _web_panel(args, runner.hooks(), dirp, ml):
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
    checkpoints (and the clustering monitor with ``--cluster-every``, the
    dashboard with ``--dash-every``, the browser panel with
    ``--web-panel``, a profiled second chunk with ``--profile``), post-train
    to the learning-ratio target, save the final and the ``postexplr``
    checkpoints, and draw the figures (and the entropy slices with
    ``--entropy-slices``). With ``--host-loop`` the exploration goes through
    ``run_host_loop`` instead. Returns the final state."""
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

    dash = None
    if args.dash_every > 0:
        from ..viz import LiveDashboard
        dash = LiveDashboard(exp, dirp)

    t0 = time.time()
    start = es.explr_step
    c = 0
    untraced = None  # the first tick after the profiled chunk
    if args.profile:
        tracing.enable(exp.device)
    with _web_panel(args, ControlHooks(), dirp, ml) as web:
        while es.explr_step < args.steps:
            if web is not None:
                while web.hooks.pause_mgr.paused:
                    time.sleep(0.2)  # the chunked loop pauses between chunks
                if web.hooks.pause_mgr.consume_save():
                    save_checkpoint(ck_dir, es, step=es.explr_step)
                    ml.write_to_log("checkpoint saved on panel request")
            before = es.explr_step
            profiling = args.profile and c == 1  # the second chunk: past the warm-up
            with _profiler(exp.device) if profiling else contextlib.nullcontext() as prof:
                es, infos = exp.run_chunk(es, min(args.chunk, args.steps - before))
                infos = {k: infos[k].float().cpu().numpy()  # waits for the chunk
                         for k in ("loss", "ergodic_cost", "beta", "gamma")}
            if profiling:
                trace = os.path.join(dirp, "profile", "trace.json")
                os.makedirs(os.path.dirname(trace), exist_ok=True)
                prof.export_chrome_trace(trace)
                ml.write_to_log(f"profiler trace -> {trace}")
                untraced = tracing.ticks()
            ml.push_tick_info(infos)
            if dash and es.explr_step // args.dash_every > before // args.dash_every:
                dash.render(es, ml.series, step=es.explr_step)
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
    if args.profile and c < 2:
        ml.write_to_log(f"no profiler trace: {c} chunk(s), the trace takes the second")
    if args.profile:
        log_spans(ml, untraced)
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
    draw_figures(exp, es, dirp, ml)
    if args.entropy_slices:
        draw_entropy_slices(exp, es, dirp, ml, args.seed)
    return es


def main(argv=None) -> ExperimentState:
    ap = build_parser()
    args = ap.parse_args(argv)
    _check_args(ap, args)
    cfg = make_config(args)
    dirp = run_dir(args.out, "synth", args.method, args.seed)
    ml = MetricsLog(dirp)
    cfg.to_yaml(os.path.join(dirp, "config.yaml"))
    es = run(make_experiment(cfg, args), args, dirp, ml)
    print(f"run dir: {dirp}")
    return es


if __name__ == "__main__":
    main()

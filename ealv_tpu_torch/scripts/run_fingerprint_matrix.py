"""Fingerprint method-matrix study with the PyTorch port (port of
``scripts/run_fingerprint_matrix.py``): learn, capture a fingerprint at each
true object centre, then evaluate every (distance method, error mode)
combination from one identification run.

    python -m ealv_tpu_torch.scripts.run_fingerprint_matrix --learn-steps 600 --id-steps 300
    python -m ealv_tpu_torch.scripts.run_fingerprint_matrix --small --device cpu \\
        --learn-steps 6 --id-steps 4 --capture-steps 3 --objects 3 --seek-mode uncertain
    python -m ealv_tpu_torch.scripts.run_fingerprint_matrix --backend arm --host-loop \\
        --cluster-every 50

Prints the true centres, each fingerprint's pose count, the calibrated
thresholds, and a table of each combination's per-object localization
error; ``--out`` saves one belief file per combination. The learning phase
runs exactly ``--learn-steps`` steps (chunks of 50 and the rest), on the
free end effector or the 7-DOF arm (``--backend arm``; the captures and the
identification then run on the arm too). ``--host-loop`` drives it through
a ``SyntheticBridge`` with the robustness layer and reports the recovery
events; ``--cluster-every N`` runs the clustering monitor after each block
of the host loop that ends within N steps of a multiple of N.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..fingerprint.capture import capture_fingerprint
from ..fingerprint.identify import FingerprintSet, calibrate_thresholds
from ..fingerprint.test_runtime import FingerprintMatrixRuntime
from ..runtime import Experiment, HostLoopRunner
from ..sim.renderer import TrayScene
from ..utils.config import ExperimentConfig
from .run_experiment import SMALL, make_monitor, monitor_update

COMBOS = (("L2", False), ("KL", False), ("BC", False), ("L2", True))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.run_fingerprint_matrix",
                                 description="Fingerprint method matrix with the port.")
    ap.add_argument("--learn-steps", type=int, default=600)
    ap.add_argument("--id-steps", type=int, default=300)
    ap.add_argument("--capture-steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--states", default="xyw")
    ap.add_argument("--out", default=None, help="directory for per-combo belief files")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--objects", type=int, default=0, metavar="K",
                    help="a K-object scene (default: the standard 2-object tray)")
    ap.add_argument("--backend", default="free", choices=["free", "arm"],
                    help="simulator backend: 'arm' is the 7-DOF kinematic arm, where "
                         "drift and joint-limit saturation occur")
    ap.add_argument("--host-loop", action="store_true",
                    help="drive the learning phase through a RobotBridge with the "
                         "robustness layer (stuck escape, pause/recover heartbeat); "
                         "the recovery events are reported")
    ap.add_argument("--seek-mode", default="fixed", choices=["fixed", "uncertain"],
                    help="'fixed' adopts one fingerprint's belief as the exploration "
                         "target; 'uncertain' the least-localized object's, every step")
    ap.add_argument("--cluster-every", type=int, default=0,
                    help="run the online clustering monitor every N learning steps "
                         "(host-loop phase only)")
    ap.add_argument("--target-sharpness", type=float, default=20.0,
                    help="belief-target sharpening exponent; 1.0 is the raw belief")
    ap.add_argument("--device", default="cuda", help="torch device of the run")
    return ap


def learn_host_loop(exp: Experiment, es, args):
    """The learning phase through a ``SyntheticBridge``: blocks of 50 steps
    (at least one step), the clustering monitor after a block when the step
    count is within a block of a multiple of ``--cluster-every``. Prints the
    rate and the recovery events; returns the final state."""
    from ..hw.bridge import SyntheticBridge
    block = 50
    t0 = time.perf_counter()
    runner = HostLoopRunner(exp, SyntheticBridge(exp.env, es.env))
    monitor = make_monitor(exp, es) if args.cluster_every > 0 else None
    t_steady, done = None, 0
    while done < args.learn_steps or done == 0:
        n = min(block, max(args.learn_steps - done, 1))
        es = runner.run(es, n)
        done += n
        if t_steady is None:
            t_steady = time.perf_counter()
        if monitor and es.explr_step % max(args.cluster_every, 1) < block:
            res, stable = monitor_update(monitor, es, 42 + int(es.buf.size))
            means = np.round(res.means[:, :2].astype(np.float64), 2).tolist()
            print(f"clusters @ {es.explr_step}: {means} stable={stable}", flush=True)
    wall = time.perf_counter() - t0
    steady = ""
    if es.explr_step - block > 0:
        steady = (f"; steady-state {(es.explr_step - block) / (time.perf_counter() - t_steady):.2f}"
                  f" Hz after the first {block}-step block")
    print(f"{es.explr_step} host-loop learning steps on '{args.backend}' backend in "
          f"{wall:.0f}s ({es.explr_step / wall:.2f} Hz{steady}); recovery events: "
          f"{runner.events or 'none'}", flush=True)
    return es


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.cluster_every > 0 and not args.host_loop:
        ap.error("--cluster-every runs in the host-loop learning phase: add --host-loop")
    dev = args.device
    cfg = ExperimentConfig(states=args.states, sim_backend=args.backend,
                           **(SMALL if args.small else {}))
    scene0 = None
    if args.objects > 0:
        scene0 = TrayScene.make(args.objects, seed=args.seed, device=dev)
        print(f"{args.objects}-object scene: "
              f"{np.round(scene0.obj_xy.cpu().numpy(), 3).tolist()}", flush=True)
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, scene=scene0, device=dev)
    es = exp.init(seed=args.seed)
    if args.host_loop:
        es = learn_host_loop(exp, es, args)
    else:
        t0 = time.perf_counter()
        losses = []
        while es.explr_step < args.learn_steps:
            es, infos = exp.run_chunk(es, min(50, args.learn_steps - es.explr_step))
            losses.append(infos["loss"].float().cpu().numpy())
        losses = np.concatenate(losses) if losses else np.zeros(0)
        losses = losses[losses != 0]
        print(f"{es.explr_step} learning steps in {time.perf_counter() - t0:.0f}s; loss "
              f"{losses[-1] if losses.size else float('nan'):.3f}", flush=True)

    # the true centres in robot coords over the states (angles at 0)
    scene = es.env.scene
    tl, rl = cfg.tray_lim, cfg.robot_lim
    truth = []
    for xy in scene.obj_xy.cpu().numpy():
        full = np.zeros(cfg.s_dim, np.float32)
        full[0], full[1] = xy
        truth.append((full - tl[:, 0]) / (tl[:, 1] - tl[:, 0]) * (rl[:, 1] - rl[:, 0])
                     + rl[:, 0])
    truth = np.stack(truth).astype(np.float32)
    print(f"true centers (robot): {np.round(truth, 3).tolist()}", flush=True)

    fps_dicts = []
    for i, ctr in enumerate(truth):
        fp = capture_fingerprint(es.model, cfg, ctr, scene=scene, num_steps=args.capture_steps,
                                 seed=i, device=dev)
        fps_dicts.append(fp)
        print(f"fingerprint {i}: {fp['x'].shape[0]} poses", flush=True)
    fps = FingerprintSet.from_lists(fps_dicts, device=dev)
    for m in ("L2", "KL", "BC"):
        th, cl = calibrate_thresholds(fps, m)
        print(f"calibrated {m}: thresh {th:.4f} clip {cl:.4f}", flush=True)

    adopt = max(10, args.id_steps // 6)
    rt = FingerprintMatrixRuntime(cfg, es.model, fps, combos=COMBOS, seek_combo=0,
                                  seek_fingerprint=0, seek_mode=args.seek_mode,
                                  update_tdist_step=adopt, scene=scene,
                                  target_sharpness=args.target_sharpness, device=dev)
    t0 = time.perf_counter()
    rt.run(n_steps=args.id_steps, seed=args.seed + 7)  # ends in the history's host copy
    print(f"{args.id_steps}-step matrix identification in {time.perf_counter() - t0:.0f}s",
          flush=True)
    if args.seek_mode == "uncertain":
        sk = np.asarray(rt.seek_history)
        post = sk[adopt:] if args.id_steps > adopt else sk
        share = [float((post == k).mean()) for k in range(len(fps_dicts))]
        print(f"seek-target share per object (post-adoption): {np.round(share, 2).tolist()}",
              flush=True)

    table = rt.results_table(truth=truth)
    print("\n| method | per-object error | mean error |")
    print("|---|---|---|")
    for key, row in table.items():
        errs = ", ".join(f"{e:.3f}" for e in row["error"])
        print(f"| {key} | {errs} | {row['mean_error']:.3f} |")
    if args.out:
        for k, p in rt.save(args.out).items():
            print(f"beliefs[{k}] -> {p}")
    return rt, table


if __name__ == "__main__":
    main()

"""Contact-rich force-learning study with the PyTorch port (port of
``scripts/force_study.py``).

Explores ``xyz`` with the force-variant CVAE (``learn_force``) on a scene
of tall, wide objects that reach into the explored z band, then assesses
the learned force channel two ways:
  1. in-distribution reconstruction of observed samples (the reference's
     force_eval): the headline metric;
  2. the force cross-decoded at probe poses, conditioned on one free-space
     observation (reported for honesty: the conditional model carries force
     mostly in the encoder's observation, so this does not transfer).

    python -m ealv_tpu_torch.scripts.force_study --steps 1200
    python -m ealv_tpu_torch.scripts.force_study --small --device cpu --steps 12
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..runtime import Experiment
from ..sim.renderer import TrayScene
from ..utils.config import ExperimentConfig
from ..utils.states import ws_conversion
from .run_experiment import SMALL


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.force_study",
                                 description="Force-learning study on a contact-rich scene.")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-samples", type=int, default=256)
    ap.add_argument("--backend", default="free",
                    choices=("free", "arm", "arm-dynamic", "arm-dynamic-soft"),
                    help="plant: 'free' height-field contact, 'arm-dynamic' the 7-DOF arm "
                         "with penalty contact mechanics (a 3-vector wrench), "
                         "'arm-dynamic-soft' compliant soft objects")
    ap.add_argument("--small", action="store_true",
                    help="the run entry's small model and images (xyz and the force "
                         "variant kept)")
    ap.add_argument("--start", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"),
                    help="tray position the robot starts from (default: the tray's "
                         "center); over an object and below its top it starts in contact")
    ap.add_argument("--device", default="cuda", help="torch device of the study")
    return ap


def _corr(a, b) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def main(argv=None) -> dict:
    """Runs the study; returns its numbers."""
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    sizes = dict(traj_buffer_capacity=3000, buffer_capacity=3000, num_target_samples=2000,
                 batch_size=64, num_learning_opt=25)
    if args.small:
        sizes = SMALL
    cfg = ExperimentConfig(states="xyz", learn_force=True, sim_backend=args.backend,
                           **sizes)
    # contact-rich: tall, wide objects (the default heights only graze the
    # z floor, so free exploration rarely makes contact)
    scene = TrayScene.default(device=dev)._replace(
        obj_radius=torch.tensor([0.07, 0.06], device=dev),
        obj_height=torch.tensor([0.38, 0.42], device=dev))
    exp = Experiment(cfg, train_calls_per_tick=1, train_every=3, scene=scene, device=dev)
    start = None
    if args.start is not None:
        start = [(lo + hi) / 2 for lo, hi in exp.tray6]
        start[:3] = args.start
    es = exp.init(seed=args.seed, start_tray_pose=start)
    t0 = time.perf_counter()
    c = 0
    while es.explr_step < args.steps:
        es, infos = exp.run_chunk(es, min(50, args.steps - es.explr_step))
        if c % 4 == 3:
            n = int(es.buf.size)
            fr = float((es.buf.force[:n] > 0).float().mean())
            losses = infos["loss"].float().cpu().numpy()
            losses = losses[losses != 0]
            print(f"step {es.explr_step}: loss "
                  f"{losses[-1] if losses.size else float('nan'):.3f} "
                  f"contact-fraction {fr:.2%}", flush=True)
        c += 1
    print(f"{es.explr_step} steps in {time.perf_counter() - t0:.0f}s", flush=True)

    n = int(es.buf.size)
    forces = es.buf.force[:n].cpu().numpy().ravel()
    print(f"buffer: {n} samples, contact {np.mean(forces > 0):.1%}, "
          f"max force {forces.max():.1f}")

    # 1. in-distribution force reconstruction (force_eval)
    n_eval = min(args.eval_samples, n)
    idx = torch.as_tensor(np.random.default_rng(args.seed).choice(n, n_eval, replace=False),
                          device=dev)
    with torch.no_grad():
        fe = es.buf.force[idx]
        out = es.model(es.buf.x[idx], es.buf.y[idx].float(), force=fe, train=False)
    fp = out["force_pred"][:, 0].cpu().numpy()
    ft = fe[:, 0].cpu().numpy()
    press = ft > 1.0
    sep = fp[press].mean() - fp[~press].mean() if press.any() and (~press).any() else 0.0
    true_sep = ft[press].mean() - ft[~press].mean() if press.any() and (~press).any() else 0.0
    recon = dict(corr=_corr(ft, fp), mae=float(np.abs(ft - fp).mean()), sep=float(sep))
    print(f"\nin-distribution force recon on {n_eval} samples: corr {recon['corr']:.3f} | "
          f"MAE {recon['mae']:.2f} | pred contact-vs-free separation {sep:.2f} "
          f"(true {true_sep:.2f})")

    # 2. cross-decoded probes from one free-space seed (honesty check)
    obj_xy = scene.obj_xy.cpu().numpy()
    probes_tray = [[ox, oy, z] for ox, oy in obj_xy for z in (0.48, 0.40, 0.34, 0.28)]
    probes_tray += [[fx, fy, z] for fx, fy in [(0.35, -0.12), (0.60, 0.12), (0.48, 0.0)]
                    for z in (0.48, 0.30)]
    probes_tray = torch.tensor(probes_tray, dtype=torch.float32, device=dev)
    truth = []
    for p in probes_tray:
        pose6 = torch.cat([p, torch.tensor([np.pi, 0.0, 0.0], device=dev)])
        if getattr(exp.env, "dynamic_contact", False):
            truth.append(float(torch.linalg.norm(exp.env._contact_wrench(pose6, scene)[0])))
        else:
            truth.append(float(exp.env._contact_force(pose6, scene)))
    truth = np.asarray(truth)
    lim = lambda a: torch.as_tensor(a, device=dev)
    probes_r = ws_conversion(probes_tray, lim(cfg.tray_lim), lim(cfg.robot_lim))
    free_env = exp.env.init(torch.tensor([0.48, -0.10, 0.45, np.pi, 0.0, 0.0], device=dev),
                            scene=scene)
    _, _, force, img = exp.env.observe(free_env)
    force = force.float().reshape(-1)
    if force.shape[0] > 1:  # a dynamic-contact wrench -> the learned |F| channel
        force = torch.linalg.norm(force)[None]
    seed_x = exp._measured_robot_state(free_env)[: cfg.s_dim]
    m = probes_r.shape[0]
    with torch.no_grad():
        out = es.model(seed_x.expand(m, -1), img[None].expand(m, *img.shape),
                       force=force.expand(m, 1), x_decode=probes_r, train=False)
    pred = out["force_pred_decode"][:, 0].cpu().numpy()
    cross = dict(corr=_corr(truth, pred), mae=float(np.abs(truth - pred).mean()))
    print(f"cross-decode probes (free-space seed): corr {cross['corr']:.3f} | "
          f"MAE {cross['mae']:.2f} (does not transfer by construction)")
    return dict(steps=es.explr_step, samples=n, contact=float(np.mean(forces > 0)),
                recon=recon, cross=cross, probes=m)


if __name__ == "__main__":
    main()
